#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py            # from the repository root, one card

Phases, one line each (any failure exits non-zero before the result):

1. device — the card's name and power limit (nvidia-smi); TF32 is turned
   off for matmuls and cuDNN so every fp32 product here is full fp32, and
   bf16 matmuls reduce in f32;
2. build — compiles every CUDA kernel of the port from ``src/`` (nvcc,
   ``sm_90a``; the cascade, the gathered tile-dot, the blocked matvec and
   the chain sum), one nvcc per source, all started together;
3. kernel — at the full qwen1.5-0.5b vocab table ((153600, 1024) in
   bf16, as the JAX package serves a bf16 model's tied embedding; n_valid
   151936, K = 4, eps = delta = 0.1) every kernel is held against
   its plain PyTorch version on the same operands and timed (the kernel:
   median of 10 launches after 2 warm-ups, CUDA events; the plain
   version; a library call as a yardstick; the bound):
   the batched fused cascade (B = 4) and the single-query fused cascade
   (one query; also bitwise equal to a B = 1 batched launch), in 'row'
   and 'coord' pull mode, for every tier: fp32 on the bf16 table (the
   ``[bf16]`` instantiation; at k_out = K and 2K, with final coverage),
   int8, int4, pq (a quant_err measured on the table) and int8 with
   adaptive early exit under the 'bernstein' radii; the fp32 tier once
   more on the table widened to f32 (row mode: the kernel table's fp32
   rows); plus a small case with fewer live rows than k_out.  Both
   entries are one cooperative launch of one CTA per SM (the grid each
   launch ran with is read back from the kernel's own gridDim, printed,
   and must equal the SM count); the batched entry runs with its batch's
   one cols row expanded (stride 0, the serve path's form: round 1 is
   read once for the batch) and must be bitwise the launch with a
   contiguous copy of cols; the two are timed
   alternately, three times each; each launch is timed again on a copy of the schedule with every
   PULL_BIT cleared (the same round ends, no pulls), which splits its time
   into round ends and pulls.  Then the
   gathered tile-dot at the tiled table's row (all 19,200 tiles, both
   512-wide blocks) and coord (C = 128, 8 blocks) geometry, and the
   blocked matvec at (153600, 1024) with (256, 512) tiles, each in f32
   and bf16 (from the table widened to f32).  Each is one persistent launch fed by bulk copies: it must
   take the bulk branch (its ``[bulk]`` launch count) with a grid, read
   back from the kernel, of min(chunks of work, SMs x CTAs per SM); its ring
   geometry, ptxas report (registers, spills, barriers) and dynamic
   shared memory are printed.  These two kernels and ``torch.matmul`` are
   timed back to back (20 launches between two CUDA events, median of 5:
   device time, the host's per-call work overlapped), with the achieved
   GB/s and share of the bound; the matvec also against ``torch.matmul``
   in 12 alternating pairs, the order swapped each pair (medians, spread,
   pairs won);
4. serve — the ``repro_torch.launch.serve --arch qwen1.5-0.5b --loop`` path
   in process on the bf16 table (its fp32 tier launches ``[bf16]``), 64
   requests, batch 4, row mode, through MIPSServeEngine,
   once per configuration: fp32, ``--precision int8``, ``--precision
   int4``, ``--precision pq`` and ``--precision int8 --adaptive --bound
   bernstein``.  The launch counts are set to 0 just before each run and
   read just after it: the run's tier must have been launched once per
   dispatch.  Every flush is then held against the plain version on the
   same permutation, and the served scores must be the exact inner
   products of the served ids;
5. runtime — the ``--loop --runtime`` path in process on the same table:
   the continuous-batching ``ServeRuntime`` (K = 4, eps = delta = 0.1,
   ``--eps-floor 0.4``, 3 rungs, 4 lanes, ``--deadline-ms 2``,
   ``--queue-capacity 16``, ``--request-deadline-ms 20``, ``--max-retries
   2``), 256 requests of the CLI's class mix, bursty open-loop arrivals
   0.1 ms apart (seed 0), four poison queries (NaN, Inf, two wrong
   widths), seeded faults (``--inject-error-rate 0.25
   --inject-latency-rate 0.05 --fault-seed 0``), for fp32 and for
   ``--precision int8 --adaptive --bound bernstein``.  ``warmup()`` runs
   before traffic.  Each tier's stream runs twice, on rungs built anew.
   Pass 1 hands the runtime's virtual clock a fixed service time of 0.6
   ms a dispatch (`RUNTIME_DT`, the runtime tests' DT; the injected
   spikes and retry backoff ride on it as always), so that nothing
   depends on the host's speed: its outcome counts, rungs launched,
   requests served per rung and dispatch errors must equal those of the
   port's plain route on the CPU at ``--smoke`` width, on the same
   stream (its repeats where the card stream's are), all five outcomes
   must occur over two rungs or more, launches of the tier equal the
   rung dispatches, and every answered dispatch agree with the plain
   version on its buffer, permutation and rung plan.  Pass 2 runs on the measured dispatch times, as
   a user's run does, and fails unless ``--check-outcomes`` holds,
   launches of the tier equal the rung executors' dispatches (warm-up
   included), every answered dispatch agrees with the plain version on
   its buffer, permutation and rung plan, served scores are the exact
   ones, every dispatch error was an injected one, and
   ``tools/check_obs_artifacts.py`` passes on the metrics, trace and
   flight artifacts.  It prints both passes' outcomes and seconds, pass
   1's measured dispatch ms per rung, and pass 2's requests served per
   rung, p50 / p95 / p99, throughput, lane use, executed pull fraction,
   retries, failed batches, each launched rung's median measured
   dispatch time, and the device memory allocated before the rungs were
   built and at the stream's peak;
6. store — the live-corpus ``DynamicTableStore`` on the vocab's 151,936
   live rows, widened to f32 as the JAX package's store takes them, at
   ``--capacity-slack 1.5`` (227,904 rows, 28,488 tiles):
   (a) for fp32, int8, int4 and pq (subdims 8, 16 codes) a store built on
   the card takes a seeded script of 64 mutations (upserts, delete +
   append pairs, appends) in 8 flushed bursts; after each burst its tiled
   table, shadow and host mirror must be bytewise a fresh store's built
   on the card from ``snapshot()`` (pq: with its codebook), no buffer may
   have moved (``data_ptr()``) and no schedule been built; (b) the runtime
   phase's stream as ``--loop --runtime --dynamic --churn-rate 0.25
   --capacity-slack 1.5 --inject-flush-rate 0.2`` for fp32 and int8:
   every rung reads the store's one tiled table, and each dispatch is
   held, before the next flush, against the plain version on the same
   buffer, permutation, store buffers and ``n_valid``, its served slots
   must be distinct live rows of live external ids, and its scores the
   float64 exact ones of those rows as they stand; after the stream
   ``--check-outcomes`` holds, launches of the tier equal the rung
   dispatches, the store's flush failures equal the injector's, no other
   update error occurred, and ``tools/check_obs_artifacts.py`` passes;
   (c) with faults off, a row of 40x the table's largest norm is appended
   along a served query: every rung's plan rebuilds once and the answer
   holds the new id; then ``grow()`` to slack 2.0, one more rebuild per
   rung, the same answer; both dispatches held as in (b).  It prints per
   tier the rows applied, flushes, tiles re-encoded and flush times, the
   outcome mix, p50 / p95 / p99 and throughput, the median dispatch ms
   per rung beside the runtime phase's, whether the cascade's round-end
   keys need the device workspace (P against ``launch_grid``'s shared
   memory capacity), and the device memory before and at peak;
7. tenancy — the ``--loop --tenants`` path in process: four tenants'
   f32 ``DynamicTableStore``s at slack 1.5, 1,024 wide, drawn on the card
   — ``vocab`` (151,936 rows, fp32, rate 8), ``items`` (524,288, int8,
   rate 2), ``cold_a`` (262,144, fp32, eps floor 0.4, rate 1) and
   ``cold_b`` (262,144, int4, rate 1), about 8.4 GB — in a
   ``TableRegistry`` whose ``--table-budget-mb`` is the ``vocab``,
   ``items`` and ``cold_b`` stores' bytes plus 5 %, so the cold tables
   page each other out; the runtime phase's settings (K = 4, eps = delta
   = 0.1, 3 rungs where a floor is set, 4 lanes, row mode, queue 16, 20
   ms request deadline), 384 bursty open-loop arrivals (seed 0) each
   tenant at its rate factor times the base rate, ``--inject-error-rate
   0.1 --inject-latency-rate 0.05 --fault-seed 0``, and 64 mutations
   staged on ``items`` at the middle arrival.  Two streams, each on
   tables built anew: at the runtime phase's 0.1 ms base spacing (the
   trace spans about 16 ms, less than one cold page-in, so what follows
   the first page-in is shed), and at 5 ms (about 0.8 s, every tenant
   served between page-ins).  Every dispatch (warm-ups too) is held against the
   plain version on its buffer, permutation and rung plan before the
   next flush, served scores must be the float64 exact ones of live
   rows; every page-in must bring back the buffers the table was
   registered (or last flushed) with, bytewise (copies kept on the card,
   outside the budget); every eviction must lower
   ``torch.cuda.memory_allocated()`` by the table's bytes; resident
   bytes never pass the budget; launches per tier equal the executors'
   dispatches; every tenant answers (at 5 ms) and no queue passes its
   capacity;
   the burst flushes; ``--check-outcomes`` and
   ``tools/check_obs_artifacts.py --expect-tenants`` hold; and every
   answered ``vocab`` dispatch is replayed through a dedicated
   ``ServeRuntime`` on a store of the same rows with the same config and
   seed: the same permutation and bitwise the same answers.  It prints
   per tenant the outcome mix, p50 / p99 and requests per rung; the
   page-outs and page-ins with each page-in's ms; executor rebuilds by
   cause with their warm ms and each tenant's first dispatch after a
   warm-up; resident bytes, the budget, device memory before and at
   peak; the median dispatch ms per tier; the stream's seconds;
8. mips — the library API on the unpadded vocab table (151936, 1024),
   widened to f32:
   8 seeded queries through ``mips_topk`` (K = 4, eps = delta = 0.1,
   ``final_exact``) per tier and pull mode, and int8 with adaptive
   bernstein; launches of ``fused_cascade[<tier>]`` must equal the calls,
   served ids be distinct rows, served scores the float64 exact ones; the
   recall@4 against exact search (through ``ops.blocked_matvec``, every
   launch on the bulk branch) is printed, and the served scores are
   recomputed through ``ops.gather_block_dot`` (bulk branch too).  Then ``nns_topk`` on 2 queries against a
   float64 nearest-neighbour search, and ``bounded_me_batched`` on 4
   queries with per-query perms: one batched launch, bitwise equal to
   four single-query calls;
9. quickstart — ``examples_torch/quickstart.py``'s ``run`` on its table
   (``mf_dataset(20000, 8192, rank=32, seed=0)``, block 128, K = 5,
   delta = 0.1, eps in {0.5, 2, 8} sigma, fp32, ``final_exact``), the
   launch counts set to 0 just before and read just after: one
   ``fused_cascade[fp32]`` launch per eps, each held against the plain
   version, exact scores; the exact top-5 held against a float64 search
   and the JAX example's printed list (equal or a near-tie), the plan's
   speedups equal to the JAX example's printed ones; prints the example's
   lines, the top-5 overlap with exact search, and the kernel (against
   its bound and the plain version) and call ms against ``torch.matmul``
   + ``torch.topk``;
10. decode — the ``repro_torch.launch.serve`` decode demo (no ``--loop``)
   in process: qwen1.5-0.5b at full width and depth, bf16 weights from a
   seeded generator on the card, 4 prompts of 16 tokens, 32 greedy
   tokens, the bandit head at eps = delta = 0.1 (after a 2-token warm-up
   on the same model) and the exact head on the same model and prompts.
   Launches of ``fused_cascade_batched[bf16]`` must equal the decode
   steps; every step's head launch is held against the plain version on
   the same hidden states, table and perm, its served score must be the
   float64 exact product of the served row, and step 0's launch must be
   bitwise the fp32 launch on the tiled table widened to f32.  Prints
   the token agreement with exact decode, the largest gap to the exact
   best row in mean-product units against eps, prefill and per-token ms
   of both heads, the head kernel's ms against its bound, the plain
   version and ``torch.matmul`` + ``torch.topk`` on the bf16 table, and
   device memory.  Then tinyllama-1.1b at full width with 2 layers (GQA,
   the untied unembedding as the head), held the same way; then
   qwen1.5-0.5b at 2 layers in fp32 on the card and on the CPU, same
   weights: equal next tokens, hidden states within rtol 1e-4;
11. sharded — the vocab table of phase 3 (nothing cut) row-sharded over a
   mesh that repeats the one card (S logical shards), through the CLI's
   own code (`serve.build_loop` with the mesh handed in): ``--loop
   --shards 4`` (64 requests, batch 4, row mode) in every tier of phase 4,
   and ``--shards 3`` (unequal live rows per shard) in fp32 and int8;
   ``--loop --runtime --shards 4`` with phase 5's settings (fp32);
   ``--loop --runtime --dynamic --shards 4`` with phase 6's churn and
   flush faults on the f32 vocab rows at slack 1.5 (a
   ``ShardedTableStore``, fp32 and int8); one sharded tenant
   (``register(mesh=)``, 151,936 rows in 4 shards) beside two paging
   tenants (131,072 rows, int8 and fp32) under a budget of the sharded
   table and one other plus 5 %, 96 arrivals 5 ms apart; and
   ``sharded_mips_topk`` at 4 shards on 8 queries.  Launches of the
   tier equal S per dispatch; every dispatch is held, before the next
   flush, against the per-shard plain versions on the same shard tables,
   perm and live counts, merged by the same rule (ids equal or a
   near-tie; int8 / int4 scores and ``rounds_used (B, S)`` bitwise; fp32
   and pq to rtol 1e-5); served scores are float64-exact; the store after
   the stream is bytewise a fresh ``ShardedTableStore`` over the same live
   ids; ``--check-outcomes`` and the obs artifacts hold; the sharded
   tenant stays pinned and its eviction raises.  Prints each run's
   dispatch ms beside phase 4's unsharded one, recall against exact
   search on the whole table, the S launches' kernel ms split into round
   ends and pulls beside phase 3's unsharded launch, and the memory held;
12. paper — the paper's own algorithms and baselines (`repro_torch.core`'s
   ``boundedme``, ``median_elim``, ``bounded_se``; `repro_torch.baselines`),
   plain PyTorch ops on the card (no kernel of the port runs: every launch
   count stays 0).  Fig. 1 at the paper's size, 10,000 arms x 100,000
   rewards (``benchmarks/fig1_guarantee.py:5``; the script cuts it to
   (2000, 20000)): 10 trials (seeds 1000 + t), each trial's f32 R (4.0 GB)
   built once on the card from the numpy draw of each row's ones (its first
   64 rows bitwise ``adversarial_dataset(64, N, seed)``) and all 20 (eps,
   delta) pairs of the script run on it; Theorem 1 must hold for every
   pair (the (1 - delta) quantile of the exact suboptimality below eps)
   and each call's ``total_pulls`` and ``rounds`` equal
   ``make_schedule``'s.  Prints ms per ``bounded_me`` call (host clock
   ending in ``torch.cuda.synchronize()``) beside its bytes' bound, and
   one exact ``R.sum(1)`` beside its bound.  Then the Figs. 2-4 regime
   (``fig23_synthetic.py``, ``fig4_real.py``: (2000, 20000), K = 5, 3
   queries with the scripts' seeds and permutations) on ``gaussian``,
   ``uniform`` and ``mf_dataset(rank=32)``: every BoundedME eps, LSH (a,
   b), GREEDY budget and PCA spill of ``fig23_synthetic.py:40-86`` on the
   card, each row's per-query ids and cost held against the port's own
   CPU run of the same calls (equal, but a tie — both id sets' exact
   float64 scores within 1e-5, costs equal — or a PCA row on a tree whose
   leaves the two SVDs made differ; both counted and printed), with the
   card's ms per call and the fastest method at precision 1.0 / 0.8 /
   0.6; and Table 1's rows (``table1_complexity.py:50-69``): the LSH,
   GREEDY and PCA builds at (1000, 4096) timed on the card against
   BoundedME's zero preprocessing, and BoundedSE against BoundedME pull
   counts, equal to the CPU's;
13. families — the decode demo of every other family at full width in
   bf16, each with the bandit head (eps = delta = 0.1, after a 2-token
   warm-up on the same model) and the exact head on the same model and
   prompts (4 prompts): qwen3-moe-30b-a3b at all 48 layers (61.1 GB, 16
   prompt tokens, 32 greedy tokens), then 16 tokens each of mamba2-130m
   and whisper-medium whole, and jamba-v0.1-52b, grok-1-314b,
   internvl2-26b (``--prompt-len 272``, past its 256 patches) and
   command-r-35b cut in depth as `FAMILY_RUNS` lists with each cut's
   reason (the card's 80 GB, the run's time).  Per arch, launches of
   ``fused_cascade_batched[bf16]`` must equal the decode steps, every
   step's launch is held against the plain version as in phase 10, and
   for qwen3-moe step 0 must be bitwise the fp32 launch on the widened
   table.  Prints the token agreement with exact decode, prefill and
   per-token ms of both heads, weights GB, peak memory, and the head
   kernel's ms against its bound, the plain version and ``torch.matmul``
   + ``torch.topk``.  Then qwen3-moe at full width with 2 layers in fp32
   on the card and on the CPU, same weights: equal next tokens, hidden
   states within rtol 1e-4;
14. train — the ``repro_torch.launch.train`` trainer in process
   (`repro_torch.launch.train.train`): (a) tinyllama-1.1b at full width
   and all 22 layers in bf16 with remat, seeded weights, at the CLI's
   defaults (batch 8, seq 128, lr 1e-3) for 16 steps of `LMStream`; the
   losses must be finite and fall from step 0 to step 15; prints ms per
   step (median of steps 2-15; the host clock around each step, ending
   in a synchronisation), tokens a second, the matmul TFLOP/s, the
   losses, weights and moments GB and the peak card GB; (b) the trained
   model served by the decode demo as in phase 10 (4 prompts of 16
   tokens, 32 greedy tokens, bandit head at eps = delta = 0.1 after a
   2-token warm-up, and the exact head): launches of
   ``fused_cascade_batched[bf16]`` must equal the decode steps, every
   launch is held against the plain version, the served scores exact,
   step 0 bitwise the fp32 launch on the widened table, and no decode
   step may build an autograd graph, though the trained parameters
   require grad; (c) at full width and 2 layers, under
   ``torch.use_deterministic_algorithms(True)`` and
   ``CUBLAS_WORKSPACE_CONFIG`` (set here, then restored), 8 steps at
   once against 4 steps, a checkpoint in a temporary directory (removed
   after), a restart at the stream's step 4 and 4 more steps: losses,
   parameters and moments bitwise; each checkpoint's GB and write and
   read seconds printed; (d) the smoke configs of tinyllama-1.1b and
   qwen3-moe-30b-a3b in f32, 3 `train_step`s on the card against the
   CPU from the same weights (`train_card_vs_cpu` states the rule); (e)
   the chain-sum kernel (the gradient of a bf16 bias, summed as XLA
   sums the JAX package's: one bf16 add and rounding per element, in
   XLA's CPU order) bitwise its plain version at `CHAIN_SHAPES` and on a
   strided input, timed at the step's shape and at mamba2's ``D`` shape
   (phase 17 (d)); then qwen1.5-0.5b at full
   width with 2 of its 24 layers in bf16, one trainer step at B = 8, S =
   128 on the card and one on a (4, 1) 'data' mesh simulated on it
   (`train_bias_chain` states what is held: every q, k, v bias gradient
   bitwise the plain chain of its own cotangent, on the mesh the ranks'
   chains summed in f32 and rounded once; the kernel launched for every
   bias, pass and rank); last the gradients of a bf16 embedding lookup
   and of the MoE's sorted token gather (the program's bf16 scatter-adds)
   on the card bitwise the CPU's; with the sub-phase's seconds; (f) the
   autograd Functions whose backward is the JAX package's op for op
   (`BACKWARD_FUNCTIONS`: SwiGLU's silu at tinyllama-1.1b's step shape,
   8 x 128 x 5,632, in bf16; mamba2-130m's f32 gate; the MoE's gate
   renormalization at qwen3-moe-30b-a3b's k = 8), forward and backward
   on the card against the CPU from the same inputs and cotangent: in
   bf16 bitwise the CPU's on the card's sigmoid values (only ``exp``
   may differ between the two), the elements apart from the CPU's own,
   those past one bf16 ulp and the most printed; in f32 every element
   within 2^-20 of the gradient's largest; each timed beside autograd's
   derivative (`train_backward_functions`);
15. train sharded — multi-card training with the ranks of each mesh
   simulated on the one card (``LocalTensorMode``, `repro_torch.launch.
   mesh.simulated_mesh`; every rank's local tensors on the card), through
   ``train(args, mesh=...)``: (a) tinyllama-1.1b at full width and 2
   layers in f32, 3 steps on each of (2, 1), (1, 2) and (2, 2) from
   phase 14's seeded weights and batches, against the single-device step
   on the card by `train_card_vs_cpu`'s rule; (b) all 22 layers in bf16
   with remat on (2, 2), the first 2 steps of phase 14 (a)'s run: losses
   beside phase 14's, per-rank parameter and moment GB, peak card GB,
   each step's collectives (`repro_torch.launch.comm_analysis`) and its
   ms (four ranks serialised on one card, not a throughput); (e) that
   model, gathered, in phase 10's decode demo for 8 tokens with the
   bandit head, the launch counts set to 0 just before and read just
   after: ``fused_cascade_batched[bf16]`` launches equal to the decode
   steps, each held against the plain version; (d) (a)'s config on (2, 2)
   halted at step 2 with a checkpoint and resumed on (2, 2) under
   deterministic algorithms, bitwise, and on (1, 2) and one device (the
   checkpoint re-sharded), within (a)'s rule; (c) qwen3-moe-30b-a3b at
   full width in f32 on (1, 4), the expert-parallel MoE, depth cut as
   `SHARDED_MOE` says, 1 step on the card against the same sharded step
   on the CPU; (f) the dry run (`repro_torch.launch.dryrun.run_cell`) of
   tinyllama-1.1b train_4k single, qwen3-moe-30b-a3b train_4k single
   (FSDP: weights gathered over 'data', gradients reduce-scattered) and
   grok-1-314b decode_32k multi, each ``ok`` with no 16-bit all-reduce
   or reduce-scatter, with each device's GB (the cells of (f) and of
   phase 16 (d) are traced in one worker process while the card runs
   phases 15 and 16);
16. mesh decode — decode over a ``DeviceMesh`` whose ranks are simulated
   on the card: (a) one ``[bf16]`` launch through the registered operator
   ``torch.ops.repro_torch.fused_cascade_batched`` bitwise the direct
   launch on phase 3's operands; (b) `sharded_bounded_me_decode` over a
   (1, 4) mesh on the serve table (B = 4, K = 4, eps = delta = 0.1), the
   fp32 tier on its bf16 cells and int8: bitwise the serving `Mesh` at S
   = 4 under the same perm, one launch per rank (counts set to 0 just
   before, read just after), each held against the plain version, rank
   0's launch timed; (c) command-r-35b at full width (`MESH_LAYERS` of 40
   layers in bf16, `MESH_LAYERS_F32` in f32) placed by `param_pspecs` on
   (2, 2): 4 prompts of 512 tokens into a 32,768-position cache split
   over 'kvseq', 16 greedy tokens with the bandit head, kernel 1 launches
   (from 0 over the decode) equal to steps x ranks, each held; tokens
   against one card's (the head over the serving `Mesh` at S = 2) and
   exact decode's (equal in f32; in bf16 equal to the mesh's exact head,
   the agreement with one card and step 0's hidden-state distance and
   top-two logit gap reported); each step's collectives by kind and
   bytes, no all-gather near one layer's K shard; ms a token (ranks run
   one after another) and peak card GB; (d) the dry run of command-r-35b
   decode_32k single, qwen3-moe-30b-a3b decode_32k multi (the bandit
   head) and qwen1.5-0.5b decode_32k single, each ``ok`` with its
   all-gather bytes below its cache bytes; (e) command-r-35b's bf16 MLP
   down projection at full width (4 x 16 tokens) on a simulated (1, 4)
   mesh through the model code's path: bitwise bf16 of the f32 sum of
   the card's own per-rank parts, its all-reduce f32 (the port reduces
   every 16-bit partial sum in f32 and rounds once, as XLA compiles the
   JAX package's bf16 psum), and the outputs where a bf16 rank-order sum
   differs reported;
17. examples — the port's examples (``examples_torch/``) on the card:
   (a) quickstart is phase 9; (b) ``serve_decode_mips.run`` at the
   example's config (qwen1.5-0.5b's smoke depth at width 256, the full
   151,936-row vocab padded to 153,600, f32) and batch (8 prompts of 12
   tokens), 30 tokens a head after a 2-token warm-up: the launch counts
   set to 0 just before and read just after, one
   ``fused_cascade_batched[fp32]`` launch per bandit step (60), each held
   as in phase 10; prints the token agreement with exact decode, ms per
   token and the head's launch against its bound; (c)
   ``frank_wolfe_lmo.run`` at the script's size (n = 1000, N = 20,000, 25
   iterations; no kernel): its three lines held to the JAX example's
   printed rel err and multiplies (on a miss, the first step whose pick
   differs from the port's CPU run, and both arms' means), and one LMO
   call of each kind timed; (d) ``train_lm``'s command line: first
   mamba2-130m at full width cut to 2 layers in f32, 2 steps on the card
   against the CPU from one draw of the weights (phase 14 (d)'s rule),
   then ``--full``: mamba2-130m at its published size (24 layers,
   d_model 768, bf16, remat), B = 8, S = 128, lr 3e-3, 20 steps, the
   checkpoint in a temporary directory; finite losses, the last below
   the first; the launch counts set to 0 just before and read just
   after: the chain kernel launched for each layer's bf16 ``D`` gradient
   in every step, once a pass, step 0's 24 sums bitwise the plain
   version's; prints ms per step (median of steps 2 on), tokens a
   second, peak card GB and the checkpoint's GB and seconds; (e) each
   script once as a user runs it, ``python examples_torch/<name>.py``
   in a subprocess under a time limit (``train_lm.py --full --steps
   10``), exit code 0, its output printed;
18. a ``kernels`` JSON line, one entry per kernel and tier (the batched
   cascade's launches are the serve, runtime, store, tenancy, decode,
   sharded, families, train, train sharded, mesh decode and examples
   phases'; its ``[bf16]`` entry times the decode head; the single-query
   cascade's are the library API's and quickstart's; the chain sum's are
   phase 14 (e)'s and 17 (d)'s), and last the ``ok`` JSON line.

Agreement rule, kernel vs plain version: ids equal per query, or — a
near-tie, counted and printed — every differing candidate's exact float64
score within 1e-5 relative of the candidate it replaced (fp32 sums taken
in another order may swap two rows whose scores tie to ~1e-7).  Scores
agree to rtol 1e-5 for the same reason; the int8 and int4 accumulators
(and so their unscaled scores) must be bitwise equal, and adaptive
``rounds_used`` equal.  The gathered tile-dot and the matvec agree with
their plain versions to rtol 1e-5 and atol 1e-5 * max|out| (products
exact in f32, sums in another order).  Served scores agree with float64
exact scores to rtol 1e-4: one fp32 sum over 1024 products of mixed sign
carries ~1e-5 relative error on values of the top-K's size.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores
INT8_OPS_PER_S = 1979e12       # H100 SXM int8, dense
BF16_FLOPS_PER_S = 989e12      # H100 SXM bf16, dense
TPU_KERNEL = "src/repro/kernels/fused_cascade.py:563"
TPU_KERNEL_SINGLE = "src/repro/kernels/fused_cascade.py:451"
TPU_GATHER = "src/repro/kernels/gather_dot.py:48"
TPU_MATVEC = "src/repro/kernels/blocked_matvec.py:33"
#: the chain sum replaces no TPU kernel: it is the bf16 ``reduce`` that
#: XLA makes of the JAX package's bias gradients (this bias add's, and
#: ``mlp``'s and whisper's ``enc_pos``)
NOT_TPU_CHAIN = ("none: the bf16 reduce of the gradient of "
                 "src/repro/models/layers.py:71's bias add")
CSRC = "src/repro_torch/kernels/csrc/"
SOURCE = CSRC + "fused_cascade.cu"
B, K, EPS, DELTA = 4, 4, 0.1, 0.1
SCORE_RTOL = 1e-5
EXACT_RTOL = 1e-4
#: the model's hidden states on the card against the CPU (fp32, TF32
#: off): matmul and softmax sums in another order, through 2 layers
CARD_CPU_RTOL = 1e-4
N_MIPS_QUERIES = 8
MF_SHAPE = (20_000, 8_192)      # examples/quickstart.py
DEV = "cuda"                    # where every entry point is asked to run
#: (label, precision, adaptive, bound) of every tier the serve path runs
TIERS = [("fp32", "fp32", False, "hoeffding"),
         ("int8", "int8", False, "hoeffding"),
         ("int4", "int4", False, "hoeffding"),
         ("pq", "pq", False, "hoeffding"),
         ("int8+adaptive", "int8", True, "bernstein")]
#: the tiers the runtime phase serves
RUNTIME_TIERS = [TIERS[0], TIERS[4]]
#: ``--loop --runtime`` under overload and injected faults
RUNTIME_ARGV = [
    "--arch", "qwen1.5-0.5b", "--loop", "--runtime", "--requests", "256",
    "--batch", "4", "--topk", str(K), "--eps", str(EPS), "--delta",
    str(DELTA), "--eps-floor", "0.4", "--degrade-rungs", "3",
    "--deadline-ms", "2", "--queue-capacity", "16",
    "--request-deadline-ms", "20", "--max-retries", "2",
    "--pattern", "bursty", "--interarrival-ms", "0.1", "--stream-seed", "0",
    "--inject-error-rate", "0.25", "--inject-latency-rate", "0.05",
    "--fault-seed", "0", "--check-outcomes"]
#: the store phase: the vocab's live rows in a DynamicTableStore
STORE_TIERS = ["fp32", "int8", "int4", "pq"]
STORE_SLACK, STORE_GROWN_SLACK = 1.5, 2.0
STORE_OPS, STORE_BURSTS = 64, 8
#: the tiers the store phase serves under ``--runtime --dynamic``
STORE_RUNTIME_TIERS = [TIERS[0], TIERS[1]]
#: ``--loop --runtime --dynamic``: the runtime phase's stream under churn
#: and injected flush faults
STORE_ARGV = RUNTIME_ARGV + [
    "--dynamic", "--churn-rate", "0.25", "--capacity-slack",
    str(STORE_SLACK), "--inject-flush-rate", "0.2"]
#: the tenancy phase's tenants: (name, rows, tier, rate factor, eps floor)
TENANTS = [("vocab", 151_936, "fp32", 8.0, None),
           ("items", 524_288, "int8", 2.0, None),
           ("cold_a", 262_144, "fp32", 1.0, 0.4),
           ("cold_b", 262_144, "int4", 1.0, None)]
#: ``--loop --tenants``: four tables under a byte budget, faults on
TENANCY_ARGV = [
    "--arch", "qwen1.5-0.5b", "--loop", "--requests", "384", "--batch", "4",
    "--topk", str(K), "--eps", str(EPS), "--delta", str(DELTA),
    "--pull-mode", "row", "--degrade-rungs", "3", "--deadline-ms", "2",
    "--queue-capacity", "16", "--request-deadline-ms", "20",
    "--max-retries", "2", "--pattern", "bursty",
    "--stream-seed", "0", "--inject-error-rate", "0.1",
    "--inject-latency-rate", "0.05", "--fault-seed", "0",
    "--flight-capacity", "8192", "--check-outcomes"]
#: the tenancy phase's streams: (``--interarrival-ms``, whether every
#: tenant must answer).  At 0.1 ms the 384 arrivals span about 16 ms, less
#: than one cold page-in: the stream measures the shedding that follows;
#: at 5 ms (about 0.8 s) every tenant is served between page-ins
TENANCY_STREAMS = [("0.1", False), ("5", True)]
#: mutations staged on ``items`` at the stream's middle arrival
TENANCY_BURST = 64
#: the tenant whose dispatches are replayed through a dedicated runtime
TENANCY_REPLAY = "vocab"


#: phase 13: (arch, layers kept or None for all, prompt tokens, decode
#: tokens, why the depth is cut)
FAMILY_RUNS = [
    ("qwen3-moe-30b-a3b", None, 16, 32, None),
    ("mamba2-130m", None, 16, 16, None),
    ("whisper-medium", None, 16, 16, None),
    ("jamba-v0.1-52b", 8, 16, 16, "one period of 8 layers, 26.5 GB: all "
     "32 layers are 102.9 GB, past the card's 80 GB"),
    ("grok-1-314b", 2, 16, 16, "2 of 64 layers, 22.9 GB: all are 633 GB"),
    ("internvl2-26b", 4, 272, 16, "4 of 48 layers, 5.4 GB: all 48 (39.8 "
     "GB) would fit, but cost the run's time"),
    ("command-r-35b", 2, 16, 16, "2 of 40 layers, 11.2 GB and its 4.2 GB "
     "tile copy: all are 64.8 GB, and the run's time")]


class SmokeFailure(Exception):
    """A check of this script failed."""


def say(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def time_cuda(fn, n: int, warmup: int) -> float:
    """Median milliseconds of ``fn`` over ``n`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(table, Q, got, ref, *, what: str, bitwise: bool = False,
            atol_scale: float = 0.0) -> dict:
    """Hold kernel (ids, vals[, rounds_used]) against the plain version's,
    per query; scores to rtol `SCORE_RTOL` and an atol of ``atol_scale``
    times the launch's largest |score|."""
    ids_k, vals_k = (t.cpu() for t in got[:2])
    ids_p, vals_p = (t.cpu() for t in ref[:2])
    check(ids_k.shape == ids_p.shape and vals_k.shape == vals_p.shape,
          f"{what}: shapes {tuple(ids_k.shape)} vs {tuple(ids_p.shape)}")
    if len(got) > 2:
        check(torch.equal(got[2].cpu(), ref[2].cpu()),
              f"{what}: rounds_used {got[2].tolist()} vs plain "
              f"{ref[2].tolist()}")
    near_ties = 0
    for b in range(ids_k.shape[0]):
        diff = (ids_k[b] != ids_p[b]).nonzero().flatten()
        if diff.numel() == 0:
            continue
        check(not bitwise, f"{what}: query {b} ids {ids_k[b].tolist()} vs "
              f"plain {ids_p[b].tolist()} on a bitwise tier")
        q = Q[b].double()
        for j in diff.tolist():
            a, c = int(ids_k[b, j]), int(ids_p[b, j])
            sa = float(table[a].double() @ q)
            sc = float(table[c].double() @ q)
            check(abs(sa - sc) <= 1e-5 * abs(sc),
                  f"{what}: query {b} position {j}: kernel id {a} "
                  f"(exact {sa:.9g}) vs plain id {c} (exact {sc:.9g})")
        near_ties += 1
    fin_k, fin_p = torch.isfinite(vals_k), torch.isfinite(vals_p)
    check(bool((fin_k == fin_p).all()),
          f"{what}: -inf entries differ between kernel and plain version")
    check(bool((vals_k[~fin_k] == vals_p[~fin_p]).all()),
          f"{what}: non-finite scores differ")
    err = float((vals_k[fin_k] - vals_p[fin_p]).abs().max()) if bool(
        fin_k.any()) else 0.0
    if bitwise:
        check(err == 0.0, f"{what}: scores differ (max abs {err:.3g}) on a "
              f"bitwise tier")
    atol = atol_scale * float(vals_p[fin_p].abs().max()) if bool(
        fin_p.any()) else 0.0
    check(torch.allclose(vals_k[fin_k], vals_p[fin_p], rtol=SCORE_RTOL,
                         atol=atol),
          f"{what}: scores differ beyond rtol {SCORE_RTOL} "
          f"(max abs {err:.3g})")
    return {"near_tie_queries": near_ties, "max_abs_err": err}


def phase_device() -> None:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(line, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    say(f"device: {torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()}, torch {torch.__version__} cuda "
        f"{torch.version.cuda}; TF32 off for matmul and cuDNN, bf16 "
        f"matmuls reduce in f32")


def phase_build() -> dict:
    """Build every kernel, one nvcc per source, all started together;
    returns each source's ptxas report."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import (blocked_matvec, chain_sum,
                                     fused_cascade, gather_dot)
    builds = {"fused_cascade": fused_cascade.build,
              "gather_dot": gather_dot.build,
              "blocked_matvec": blocked_matvec.build,
              "chain_sum": chain_sum.build}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        futures = {name: pool.submit(fn) for name, fn in builds.items()}
        results = {name: f.result() for name, f in futures.items()}
    for name, (path, log) in results.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        say(f"build: {name} -> {path.name} {' '.join(regs)}")
    say(f"build: {len(builds)} kernel(s) in "
        f"{time.perf_counter() - t0:.2f} s")
    return {name: log for name, (_, log) in results.items()}


def ptxas_report(log: str, instance: str) -> str:
    """The ptxas lines (registers, barriers, spills, static shared memory)
    of the entry functions whose mangled names contain ``instance``."""
    out, current = [], None
    for line in log.splitlines():
        m = re.search(r"(?:entry function|Function properties for) '?"
                      r"([\w$]+)", line)
        if m:
            current = m.group(1)
        elif current and instance in current and (
                "Used" in line or "spill" in line or "smem" in line):
            out.append(line.replace("ptxas info    :", "").strip())
    return "; ".join(dict.fromkeys(out))


def cascade_operands(plan, V4, Q, perm, *, adaptive=False, quantized=None):
    """The fused cascade's operands and keywords for one batch, built as
    `decode_tiled` builds them."""
    from repro_torch.core.boundedme_torch import decode_operands
    from repro_torch.core.quantize import quantize_blocks
    slotcode, rmeta, bpos, t_final, n_final, cert = decode_operands(
        plan, final_exact=True, adaptive=adaptive, device=V4.device)
    Qb = Q.reshape(Q.shape[0], plan.n_blocks, plan.block).contiguous()
    # one perm for the batch: one cols row expanded, as `_fused_call` does
    cols = perm.to(V4.device)[bpos].to(torch.int32).expand(Q.shape[0], -1)
    kw = dict(n_arms=plan.n, K=plan.K, t_final=t_final, n_final=n_final)
    table = V4
    if plan.precision == "pq":
        table, kw["codebook"] = quantized
    elif plan.precision != "fp32":
        table, kw["vscale"] = quantized
        Qb, kw["qscale"] = quantize_blocks(Qb)
        kw["packed_int4"] = plan.precision == "int4"
    if adaptive:
        kw.update(cert=cert, k_cert=plan.K,
                  track_var=plan.schedule.bound == "bernstein")
    return (table, Qb, slotcode, rmeta, cols), kw


def single_of(ops, kw, b: int = 0, keep_batch: bool = False):
    """Query ``b`` of a batch's operands: single-query operands, or with
    ``keep_batch`` a batch of one."""
    table, Qb, slotcode, rmeta, cols = ops
    sl = slice(b, b + 1) if keep_batch else b
    skw = dict(kw)
    if "qscale" in kw:
        skw["qscale"] = kw["qscale"][sl].contiguous()
    return (table, Qb[sl].contiguous(), slotcode, rmeta,
            cols[sl].contiguous()), skw


def tier_plan(table, n_valid, precision, bound, mode):
    from repro_torch.core.boundedme_torch import make_measured_plan, make_plan
    from repro_torch.core.mips import table_abs_max
    n, N = table.shape
    kw = dict(K=K, eps=EPS, delta=DELTA,
              value_range=2.0 * table_abs_max(table), precision=precision,
              bound=bound, pull_mode=mode)
    if precision == "pq":
        return make_measured_plan(table, device=DEV, **kw)
    return make_plan(n, N, **kw)


def kernel_bound(plan, ops, kw, pulled, n_pulls) -> dict:
    """Least time for the work of one launch: each input read once (the
    union of pulled table cells, ``pulled (n_tiles, n_blocks)``, at the
    tier's stored bytes for the block's valid columns, their scales or the
    codebook, the queries and schedule operands), each output written
    once; and the pull operations over the pulled blocks' valid columns
    at the card's peak rate for their type.  A ragged last block (``N``
    not a multiple of ``C``) counts only its ``N - b * C`` columns."""
    from repro_torch.core.schedule import PULL_BIT
    R, C = plan.tile, plan.block
    table, Qb, slotcode, rmeta, cols = ops
    nq = Qb.shape[0] if Qb.dim() == 3 else 1
    if cols.dim() == 2 and cols.stride(0) == 0:
        cols = cols[0]             # one row, read once
    width = torch.clamp(plan.N - C * torch.arange(plan.n_blocks,
                                                  device=pulled.device),
                        max=C).double() / C       # valid share per block
    cells = int(pulled.sum())
    valid_cells = float((pulled.sum(0).double() * width).sum())
    # the pull steps' blocks, per query: their mean valid share
    steps = (slotcode & PULL_BIT) != 0
    step_cols = cols[..., steps.to(cols.device)].long()
    pull_share = (float(width.to(cols.device)[step_cols].mean())
                  if step_cols.numel() else 1.0)
    nbytes = (valid_cells * R * table.shape[3] * table.element_size()
              + sum(t.numel() * t.element_size()
                    for t in (Qb, slotcode, rmeta, cols))
              + nq * kw.get("k_out", plan.K) * 8)
    if plan.precision in ("int8", "int4"):
        nbytes += cells * 4 + kw["qscale"].numel() * 4
        t_ops = 2 * n_pulls * R * C * pull_share / INT8_OPS_PER_S
    elif plan.precision == "pq":
        cb = kw["codebook"]
        nbytes += cb.numel() * 4
        lut_flops = 2 * nq * cb.numel()
        t_ops = ((lut_flops + n_pulls * R * table.shape[3] * pull_share)
                 / FP32_FLOPS_PER_S)
    else:
        t_ops = 2 * n_pulls * R * C * pull_share / FP32_FLOPS_PER_S
    if "cert" in kw:
        nbytes += kw["cert"].numel() * 4 + nq * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    return {"bytes": nbytes, "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def pull_split(fn, ops, kernel_ms, **kw) -> dict:
    """Time ``fn`` on a copy of the schedule with every step's PULL_BIT
    cleared: the same round ends, no pulls.  That time is the launch's
    round-end time; ``kernel_ms`` minus it is its pull time."""
    from repro_torch.core.schedule import PULL_BIT
    table, Qb, slotcode, rmeta, cols = ops
    idle = (table, Qb, slotcode & ~PULL_BIT, rmeta, cols)
    ends_ms = time_cuda(lambda: fn(*idle, **kw), 10, 2)
    return {"round_end_ms": ends_ms, "pull_ms": kernel_ms - ends_ms}


def tier_tag(label: str, table) -> str:
    """The launch-count tag of a tier on ``table``: the fp32 tier pulls a
    bf16 table's own cells and counts as ``[bf16]``."""
    return "bf16" if label == "fp32" and table.dtype == torch.bfloat16 \
        else label


def phase_kernel(table, table32, n_valid) -> dict:
    from repro_torch.core.boundedme_torch import quantize_table, tile_table
    from repro_torch.core.schedule import PULL_BIT, pulls_through_round
    from repro_torch.kernels.fused_cascade import (fused_cascade_batched_cuda,
                                                   fused_cascade_cuda,
                                                   launch_grid, launched_grid)
    from repro_torch.kernels.ref import (fused_cascade_batched_ref,
                                         fused_cascade_ref)
    from repro_torch.launch.engine import seeded_perm

    _, capacity = launch_grid(table.device)
    sms = torch.cuda.get_device_properties(table.device).multi_processor_count
    launched_grid(table.device)          # clear the word the launches write

    def grid_of(what):
        """The grid the last launch ran with, read back from the kernel's
        own gridDim; it must be one CTA per SM."""
        ctas = launched_grid(table.device)
        check(ctas == sms, f"{what}: launched {ctas} CTAs on {sms} SMs")
        return ctas
    n, N = table.shape
    Q = torch.from_numpy(np.random.default_rng(1234).normal(
        size=(B, N)).astype(np.float32)).cuda()
    mask = torch.arange(n, device=table.device)[:, None] >= n_valid
    out, single = {}, {}
    # the serving table (bf16) in both modes and every tier, and the
    # fp32 tier once more on the table widened to f32, row mode: the fp32
    # rows of the kernel table, comparable with earlier runs'
    for tab, mode, tiers in ((table, "row", TIERS), (table, "coord", TIERS),
                             (table32, "row", TIERS[:1])):
        # exact search on the same table: a bf16 table meets the queries
        # rounded to bf16, as a bf16 server would search it
        Qt = Q.to(tab.dtype)

        def library():
            s = (tab @ Qt.T).masked_fill_(mask, -torch.inf)
            return torch.topk(s, K, dim=0)

        def library1():              # the same for one query
            s = (tab @ Qt[0]).masked_fill_(mask[:, 0], -torch.inf)
            return torch.topk(s, K)
        library_ms = time_cuda(library, 10, 2)
        library1_ms = time_cuda(library1, 10, 2)
        V4 = None
        for label, precision, adaptive, bound in tiers:
            tag = tier_tag(label, tab)
            plan = tier_plan(tab, n_valid, precision, bound, mode)
            if V4 is None:
                V4 = tile_table(tab, plan, DEV)
            quant = (quantize_table(V4, plan) if precision != "fp32"
                     else None)
            perm = seeded_perm(0, 0, plan.n_blocks)
            ops, kw = cascade_operands(plan, V4, Q, perm, adaptive=adaptive,
                                       quantized=quant)
            bitwise = precision in ("int8", "int4")
            errs, ties = [], 0
            for k_out in ((K, 2 * K) if label == "fp32" else (K,)):
                pulled = torch.zeros((plan.n_tiles, plan.n_blocks),
                                     dtype=torch.bool, device=V4.device)
                got = fused_cascade_batched_cuda(*ops, k_out=k_out,
                                                 n_valid=n_valid, **kw)
                ctas = grid_of(f"{tag} {mode} B={B}")
                ref = fused_cascade_batched_ref(*ops, k_out=k_out,
                                                n_valid=n_valid,
                                                pulled=pulled, **kw)
                torch.cuda.synchronize()
                r = compare(tab, Q, got, ref, bitwise=bitwise,
                            what=f"{tag} {mode} k_out={k_out}")
                errs.append(r["max_abs_err"])
                ties += r["near_tie_queries"]
                if k_out == K:
                    cells = pulled
                    rounds = got[2].tolist() if adaptive else None
                    # the same launch with per-query cols, bit for bit
                    own = (*ops[:4], ops[4].contiguous())
                    again = fused_cascade_batched_cuda(
                        *own, k_out=k_out, n_valid=n_valid, **kw)
                    torch.cuda.synchronize()
                    check(all(torch.equal(x, y) for x, y in zip(got, again)),
                          f"{tag} {mode}: the shared round-1 read is not "
                          f"bitwise the launch without it")
            steps = int(((ops[2].cpu() & PULL_BIT) != 0).sum())
            through = pulls_through_round(plan.schedule)
            if adaptive:   # the pulls this run's queries made
                n_pulls = int(sum(through[r] for r in rounds))
            else:
                n_pulls = steps * B
            bound_info = kernel_bound(plan, ops, kw, cells, n_pulls)
            kernel_ms = time_cuda(lambda: fused_cascade_batched_cuda(
                *ops, n_valid=n_valid, **kw), 10, 2)
            split = pull_split(fused_cascade_batched_cuda, ops, kernel_ms,
                               n_valid=n_valid, **kw)
            # the shared read against per-query cols, alternated 3 times
            on_ms, own_ms = [], []
            for _ in range(3):
                on_ms.append(time_cuda(lambda: fused_cascade_batched_cuda(
                    *ops, n_valid=n_valid, **kw), 10, 2))
                own_ms.append(time_cuda(lambda: fused_cascade_batched_cuda(
                    *own, n_valid=n_valid, **kw), 10, 2))
            plain_ms = time_cuda(lambda: fused_cascade_batched_ref(
                *ops, n_valid=n_valid, **kw), 3, 1)
            res = {
                "S": ops[2].numel(), "rounds": len(plan.schedule.rounds),
                "quant_err": plan.quant_err,
                "eps_effective": plan.eps_effective,
                "speedup": plan.schedule.speedup, "pulls": n_pulls,
                "union_cells": int(cells.sum()), **bound_info,
                "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                "library_ms": library_ms, "max_abs_err": max(errs),
                "near_tie_queries": ties, **split,
                "shared_cols_ms_runs": on_ms, "per_query_cols_ms_runs": own_ms,
                "shared_cols_bitwise": True, "grid_ctas": ctas, "sms": sms}
            if adaptive:
                res["rounds_used"] = rounds
            out[(tag, mode)] = res
            say(f"kernel {tag} {mode}: " + json.dumps(res))

            # the single-query entry on query 0, held against its plain
            # version and, bit for bit, against a B = 1 batched launch
            sops, skw = single_of(ops, kw)
            pulled = torch.zeros((plan.n_tiles, plan.n_blocks),
                                 dtype=torch.bool, device=V4.device)
            got = fused_cascade_cuda(*sops, n_valid=n_valid, **skw)
            ctas1 = grid_of(f"single {tag} {mode}")
            ref = fused_cascade_ref(*sops, n_valid=n_valid, pulled=pulled,
                                    **skw)
            bops, bkw = single_of(ops, kw, keep_batch=True)
            one = fused_cascade_batched_cuda(*bops, n_valid=n_valid, **bkw)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b[0]) for a, b in zip(got, one)),
                  f"single {tag} {mode}: not bitwise a B = 1 batched "
                  f"launch")
            r = compare(tab, Q[:1], [t[None] for t in got],
                        [t[None] for t in ref], bitwise=bitwise,
                        what=f"single {tag} {mode}")
            rounds1 = [int(got[2])] if adaptive else None
            n_pulls = (int(through[rounds1[0]]) if adaptive else steps)
            bound_info = kernel_bound(plan, sops, skw, pulled, n_pulls)
            kernel1_ms = time_cuda(lambda: fused_cascade_cuda(
                *sops, n_valid=n_valid, **skw), 10, 2)
            res1 = {"pulls": n_pulls, "union_cells": int(pulled.sum()),
                    **bound_info, "kernel_ms": kernel1_ms,
                    **pull_split(fused_cascade_cuda, sops, kernel1_ms,
                                 n_valid=n_valid, **skw),
                    "plain_ms": time_cuda(lambda: fused_cascade_ref(
                        *sops, n_valid=n_valid, **skw), 3, 1),
                    "library_ms": library1_ms,
                    "max_abs_err": r["max_abs_err"],
                    "near_tie_queries": r["near_tie_queries"],
                    "bitwise_batch_of_one": True, "grid_ctas": ctas1,
                    "sms": sms}
            if adaptive:
                res1["rounds_used"] = rounds1
            single[(tag, mode)] = res1
            say(f"single {tag} {mode}: " + json.dumps(res1))
            del ops, pulled, quant, sops, bops
        del V4
        torch.cuda.empty_cache()

    # fewer live rows than k_out: filler ids carry -inf and never repeat
    from repro_torch.core.boundedme_torch import make_plan
    rng = np.random.default_rng(5)
    small = torch.from_numpy(rng.normal(size=(96, 512)).astype(
        np.float32)).cuda()
    Qs = torch.from_numpy(rng.normal(size=(2, 512)).astype(
        np.float32)).cuda()
    for precision in ("fp32", "int8"):
        plan = make_plan(96, 512, K=5, eps=0.7, delta=0.1, value_range=8.0,
                         block=64, precision=precision)
        V4s = tile_table(small, plan, DEV)
        ops, kw = cascade_operands(
            plan, V4s, Qs, seeded_perm(0, 1, plan.n_blocks),
            quantized=(quantize_table(V4s, plan) if precision != "fp32"
                       else None))
        got = fused_cascade_batched_cuda(*ops, k_out=7, n_valid=3, **kw)
        ref = fused_cascade_batched_ref(*ops, k_out=7, n_valid=3, **kw)
        compare(small, Qs, got, ref, bitwise=precision == "int8",
                what=f"small {precision} n_valid=3 k_out=7")
        for b in range(2):
            ids, vals = got[0][b].cpu(), got[1][b].cpu()
            check(sorted(ids[torch.isfinite(vals)].tolist()) == [0, 1, 2]
                  and len(set(ids.tolist())) == 7,
                  f"small {precision} case: live ids {ids.tolist()} / "
                  f"scores {vals.tolist()}")
        sops, skw = single_of(ops, kw, b=1)
        got = fused_cascade_cuda(*sops, k_out=7, n_valid=3, **skw)
        ref = fused_cascade_ref(*sops, k_out=7, n_valid=3, **skw)
        compare(small, Qs[1:], [t[None] for t in got], [t[None] for t in ref],
                bitwise=precision == "int8",
                what=f"single small {precision} n_valid=3 k_out=7")
        ids, vals = got[0].cpu(), got[1].cpu()
        check(sorted(ids[torch.isfinite(vals)].tolist()) == [0, 1, 2]
              and len(set(ids.tolist())) == 7,
              f"single small {precision} case: live ids {ids.tolist()}")
    say("kernel small: fewer live rows than k_out ok (fp32, int8; batched "
        "and single-query)")
    return out, single


def time_back_to_back(fn, n: int = 20, reps: int = 5, warmup: int = 3
                      ) -> float:
    """Median over ``reps`` of the milliseconds per launch of ``n``
    launches of ``fn`` back to back between two CUDA events: the host's
    per-call work overlaps the card's, so this is device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def alternate(fn, other, pairs: int = 12) -> dict:
    """``pairs`` back-to-back timings of ``fn`` and ``other`` in turns,
    the order swapped every pair (fn first, then other first)."""
    a, b = [], []
    for i in range(pairs):
        for which in ((0, 1) if i % 2 == 0 else (1, 0)):
            (a if which == 0 else b).append(time_back_to_back(
                fn if which == 0 else other, reps=1))
    return {"pairs": pairs, "kernel_ms": a, "library_ms": b,
            "kernel_median_ms": statistics.median(a),
            "library_median_ms": statistics.median(b),
            "kernel_spread_ms": max(a) - min(a),
            "library_spread_ms": max(b) - min(b),
            "kernel_faster_pairs": sum(x < y for x, y in zip(a, b))}


def time_kernel_aux(fn, ref, args, *, what: str, nbytes: int,
                    flops: int, flops_per_s: float, library=None) -> dict:
    """Hold ``fn(*args)`` against ``ref(*args)`` and time both, a library
    call and the bound (bytes moved once, operations at peak).  The kernel
    and the library call are timed back to back (device time)."""
    got, want = fn(*args), ref(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    check(got.shape == want.shape and got.dtype == torch.float32
          and torch.allclose(got, want, rtol=1e-5, atol=1e-5 * scale),
          f"{what}: kernel vs plain max abs {err:.3g} (scale {scale:.3g})")
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    kernel_ms = time_back_to_back(lambda: fn(*args))
    bound_ms = 1e3 * max(t_bytes, t_ops)
    return {"bytes": nbytes, "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "kernel_ms": kernel_ms, "gb_per_s": nbytes / kernel_ms / 1e6,
            "share_of_bound": bound_ms / kernel_ms,
            "plain_ms": time_cuda(lambda: ref(*args), 3, 1),
            "library_ms": (time_back_to_back(lambda: library(*args))
                           if library else None),
            "max_abs_err": err}


def stream_launch(module, name: str, fn, args, work: int, geo, logs,
                  source: str) -> dict:
    """One launch of a streaming kernel at full width: it must take the
    bulk branch and run with a grid of min(chunks of the work, SMs x CTAs
    per SM)."""
    from repro_torch.kernels import ops as kops
    dtype = args[0].dtype
    code = module.DTYPES.index(dtype)
    sms, per_sm = module.occupancy(args[0].device, code, geo.bulk, geo.smem)
    before = kops.launch_counts()
    module.launched_grid(args[0].device)
    fn(*args)
    ctas = module.launched_grid(args[0].device)
    after = kops.launch_counts()
    check(geo.bulk and after[f"{name}[bulk]"] == before[f"{name}[bulk]"] + 1,
          f"{name} {dtype}: the full-width launch took the "
          f"{geo.branch} branch")
    chunks = geo.chunks(work)
    check(ctas == min(chunks, sms * per_sm),
          f"{name} {dtype}: grid {ctas}, expected min({chunks} chunks, "
          f"{sms} x {per_sm})")
    instance = ("If" if dtype == torch.float32 else "I13__nv_bfloat16") \
        + "Lb1E"
    return {"branch": geo.branch, "grid_ctas": ctas, "sms": sms,
            "ctas_per_sm": per_sm, "chunks": chunks,
            "chunk": geo.chunk, "stages": geo.stages,
            "stage_bytes": geo.stage_bytes, "group": geo.group,
            "dynamic_smem": geo.smem,
            "ptxas": ptxas_report(logs[source], instance)}


def phase_aux_kernels(table, logs) -> dict:
    """The gathered tile-dot and the blocked matvec at the serving table's
    geometry, f32 and bf16, against their plain versions; kernel 4 also
    against ``torch.matmul`` in alternating pairs."""
    from repro_torch.core.boundedme_torch import make_plan, tile_table
    from repro_torch.kernels import blocked_matvec as bmv
    from repro_torch.kernels import gather_dot as gd
    from repro_torch.kernels import stream
    from repro_torch.kernels.ref import (blocked_matvec_ref,
                                         gather_block_dot_ref)
    from repro_torch.launch.engine import seeded_perm

    n, N = table.shape
    q = torch.from_numpy(np.random.default_rng(99).normal(size=N).astype(
        np.float32)).cuda()
    rates = {torch.float32: FP32_FLOPS_PER_S,
             torch.bfloat16: BF16_FLOPS_PER_S}
    out = {}
    for mode, block in (("row", 512), ("coord", 128)):
        plan = make_plan(n, N, K=K, block=block)
        V4f = tile_table(table, plan, DEV)
        idx = torch.arange(plan.n_tiles, dtype=torch.int32, device=DEV)
        cols = seeded_perm(0, 0, plan.n_blocks).to(torch.int32).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            V4 = V4f.to(dtype)
            qsel = q.reshape(plan.n_blocks, block)[cols.long()].to(dtype)
            T, dt, R = plan.n_tiles, plan.n_blocks, plan.tile
            geo = stream.gather_stream(R, block, V4.element_size(), dt,
                                       V4.data_ptr())
            launch = stream_launch(gd, "gather_block_dot",
                                   gd.gather_block_dot_cuda,
                                   (V4, idx, cols, qsel), T, geo, logs,
                                   "gather_dot")
            nbytes = (V4.numel() * V4.element_size()
                      + qsel.numel() * qsel.element_size()
                      + 4 * (T + dt) + 4 * T * R)
            res = time_kernel_aux(
                gd.gather_block_dot_cuda, gather_block_dot_ref,
                (V4, idx, cols, qsel), what=f"gather_block_dot {mode} "
                f"{dtype}", nbytes=nbytes, flops=2 * T * dt * R * block,
                flops_per_s=rates[dtype])
            res.update(launch, shape=list(V4.shape))
            out[("gather_block_dot", mode, dtype)] = res
            say(f"gather_block_dot {mode} {str(dtype)[6:]}: "
                + json.dumps(res))
            del V4
        del V4f
    for dtype in (torch.float32, torch.bfloat16):
        W, qd = table.to(dtype), q.to(dtype)
        geo = stream.matvec_stream(N, 512, W.element_size(), W.data_ptr())
        launch = stream_launch(bmv, "blocked_matvec", bmv.blocked_matvec_cuda,
                               (W, qd), n, geo, logs, "blocked_matvec")
        nbytes = (W.numel() + qd.numel()) * W.element_size() + 4 * n
        res = time_kernel_aux(
            bmv.blocked_matvec_cuda, blocked_matvec_ref, (W, qd),
            what=f"blocked_matvec {dtype}", nbytes=nbytes, flops=2 * n * N,
            flops_per_s=rates[dtype], library=torch.matmul)
        res.update(launch, shape=[n, N])
        res["against_matmul"] = alternate(
            lambda: bmv.blocked_matvec_cuda(W, qd),
            lambda: torch.matmul(W, qd))
        out[("blocked_matvec", dtype)] = res
        say(f"blocked_matvec {str(dtype)[6:]}: " + json.dumps(res))
        del W
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def plain_route():
    """Send CUDA tensors to the plain PyTorch versions (for the reference
    answers only: no launch is counted inside)."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    kernels = (kops.fused_cascade_batched_cuda, kops.fused_cascade_cuda)
    kops.fused_cascade_batched_cuda = ref.fused_cascade_batched_ref
    kops.fused_cascade_cuda = ref.fused_cascade_ref
    try:
        yield
    finally:
        kops.fused_cascade_batched_cuda, kops.fused_cascade_cuda = kernels


def untiled(ex, n: int, N: int) -> torch.Tensor:
    """The (n, N) table an executor serves, from its tile-major copy."""
    V4 = ex.tiled_table
    return V4.permute(0, 2, 1, 3).reshape(-1, V4.shape[1] * V4.shape[3])[
        :n, :N]


def check_served(table, q, ids, scores, n_valid, what: str) -> None:
    """Served ids distinct live rows, served scores the exact ones."""
    check(len(set(ids.tolist())) == K and int(ids.max()) < n_valid,
          f"{what}: ids {ids.tolist()}")
    exact = (table[torch.from_numpy(ids.astype(np.int64)).cuda()].double()
             @ torch.from_numpy(q).cuda().double()) / table.shape[1]
    check(np.allclose(scores, exact.cpu().numpy(), rtol=EXACT_RTOL,
                      atol=0.0),
          f"{what}: scores {scores.tolist()} vs exact {exact.tolist()}")


def serve_run(label, precision, adaptive, bound) -> dict:
    from repro_torch.core.boundedme_torch import decode_tiled
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import serve

    argv = ["--arch", "qwen1.5-0.5b", "--loop", "--requests", "64",
            "--batch", "4", "--pull-mode", "row", "--precision", precision,
            "--bound", bound] + (["--adaptive"] if adaptive else [])
    args = serve.parse_args(argv)
    engine, qs = serve.build_loop(args)
    ex = engine.executor
    flushes = []
    dispatch = ex.dispatch

    def recording_dispatch(Qbuf, perm):
        out = dispatch(Qbuf, perm)
        flushes.append((Qbuf.copy(), perm, out))
        return out
    ex.dispatch = recording_dispatch
    plan = engine.plan
    say(f"serve {label}: table=({engine.n},{engine.N}) n_valid={ex.n_valid} "
        f"rounds={len(plan.schedule.rounds)} precision={plan.precision} "
        f"quant_err={plan.quant_err:.6g} eps_eff={plan.eps_effective:.4f} "
        f"adaptive={adaptive} bound={bound} pull_mode={plan.pull_mode} "
        f"block={plan.block}")
    name = f"fused_cascade_batched[{tier_tag(label, ex.tiled_table)}]"
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    stats = serve.simulate_stream(engine, qs,
                                  interarrival_ms=args.interarrival_ms,
                                  pattern=args.pattern,
                                  seed=args.stream_seed)
    wall = time.perf_counter() - t0
    counts = kops.launch_counts()
    launches = counts[name]
    check(ex.n_dispatches > 0 and launches == ex.n_dispatches
          and counts["fused_cascade_batched"] == ex.n_dispatches,
          f"serve {label}: {launches} {name} launches "
          f"({counts['fused_cascade_batched']} in all) for "
          f"{ex.n_dispatches} dispatches")
    check(stats["completed"] == args.requests,
          f"serve {label}: {stats['completed']} of {args.requests} "
          f"completed")

    table = untiled(ex, engine.n, engine.N)
    errs, ties = [], 0
    for Qbuf, perm, out in flushes:
        Q = torch.from_numpy(Qbuf).cuda()
        with plain_route():
            ref = decode_tiled(ex.tiled_table, Q, perm, plan=plan,
                               final_exact=True, n_valid=ex.n_valid,
                               quantized=ex.quantized, adaptive=adaptive)
        got = [torch.from_numpy(out[0]), torch.from_numpy(out[1])]
        if adaptive:
            got.append(torch.from_numpy(out[2]))
        r = compare(table, Q, got, ref, what=f"serve {label} flush")
        errs.append(r["max_abs_err"])
        ties += r["near_tie_queries"]
    for rid in range(args.requests):
        res = engine.result(rid)
        check(res is not None, f"serve {label}: request {rid} has no result")
        check_served(table, qs[rid], *res, ex.n_valid,
                     f"serve {label}: request {rid}")
    lat = stats["latency_ms"]
    res = {"launches": launches, "dispatches": ex.n_dispatches,
           "max_abs_err": max(errs), "near_tie_queries": ties,
           "dispatch_ms_median": 1e3 * statistics.median(
               out[3] for _, _, out in flushes),
           "p50_ms": lat["p50"], "p95_ms": lat["p95"],
           "throughput_rps": stats["throughput_rps"], "wall_s": wall,
           "cache_hits": stats["cache"]["hits"],
           "recall": stats["recall"]["mean"],
           "recall_samples": stats["recall"]["samples"]}
    if adaptive:
        res["adaptive"] = stats["adaptive"]
    say(f"serve {label}: " + json.dumps(res))
    return res


#: phase 5's fixed service time, ``tests/test_torch_runtime.py``'s DT:
#: pass 1 reports it to the runtime's clock for every rung dispatch
RUNTIME_DT = 6e-4
#: the requests of phase 5's stream that carry poison queries
RUNTIME_POISON = (5, 70, 140, 210)


def runtime_queries(qs, N: int, like=None) -> list:
    """Phase 5's queries: ``qs`` (`serve.build_loop`'s) with a NaN, an Inf
    and two wrong-width queries at `RUNTIME_POISON`.  Given ``like``,
    another width's stream of the same flags, the queries are drawn anew
    at width ``N`` and each one that repeats an earlier one in ``like``
    repeats the same one here: the two streams then hit the result cache
    and the quarantine alike (`build_loop` draws its repeats after its
    queries, from a generator whose state depends on the width)."""
    qs = list(qs)
    if like is not None:
        fresh = np.random.default_rng(0).normal(size=(len(like), N))
        first = {}
        qs = [fresh[first.setdefault(np.asarray(q).tobytes(), i)].astype(
            np.float32) for i, q in enumerate(like)]
    for i, bad in zip(RUNTIME_POISON, (
            np.full(N, np.nan, np.float32), np.full(N, np.inf, np.float32),
            np.ones(N + 1, np.float32), np.ones(N - 3, np.float32))):
        qs[i] = bad
    return qs


def hold_runtime_dispatches(label: str, what: str, execs, table,
                            dispatches, adaptive: bool):
    """Each recorded rung dispatch ``(rung, Qbuf, perm, out)`` of a
    runtime stream against the plain version on its buffer, permutation
    and rung plan (`compare`): ``(max_abs_err, near_tie_queries)``."""
    from repro_torch.core.boundedme_torch import decode_tiled
    errs, ties = [0.0], 0
    for rung, Qbuf, perm, out in dispatches:
        ex = execs[rung]
        Q = torch.from_numpy(Qbuf).cuda()
        with plain_route():
            ref = decode_tiled(ex.tiled_table, Q, perm, plan=ex.plan,
                               final_exact=True, n_valid=ex.n_valid,
                               quantized=ex.quantized, adaptive=adaptive)
        got = [torch.from_numpy(t) for t in out[:3 if adaptive else 2]]
        r = compare(table, Q, got, ref,
                    what=f"runtime {label} {what}rung {rung} dispatch")
        errs.append(r["max_abs_err"])
        ties += r["near_tie_queries"]
    return max(errs), ties


def runtime_fixed_pass(argv, label: str, like=None, adaptive=None) -> dict:
    """Pass 1 of phase 5: the ``--loop --runtime`` stream of ``argv`` with
    every rung dispatch reporting `RUNTIME_DT` to the runtime's virtual
    clock in place of its measured seconds (the runtime adds the
    injected spikes and retry backoff itself, as in pass 2).  No count
    then depends on the host's speed: the outcomes, the rungs launched
    and the requests served per rung follow from the seeds alone.
    ``like`` as in `runtime_queries`.  Given ``adaptive`` (the card's
    pass), every dispatch after the warm-up is held against the plain
    version (`hold_runtime_dispatches`).  Returns those counts
    (``fixed``), the stream's raw queries, the launches of ``label``'s
    tier and of the batched cascade in all, the rung dispatches (warm-ups
    included) and those held, the holds' largest error and near-ties,
    the measured dispatch seconds per rung and the wall seconds."""
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import serve
    t0 = time.perf_counter()
    args = serve.parse_args(argv)
    engine, raw = serve.build_loop(args)
    qs = runtime_queries(raw, engine.N, like)
    kops.reset_launch_counts()
    engine.warmup()
    measured, dispatches = [], []
    for rung, ex in enumerate(engine.executors):
        def fixed(Qbuf, perm, rung=rung, real=ex.dispatch):
            out = real(Qbuf, perm)
            measured.append((rung, out[3]))
            if adaptive is not None:
                dispatches.append((rung, Qbuf.copy(), perm, out))
            return (*out[:3], RUNTIME_DT)
        ex.dispatch = fixed
    stats = serve.serve_stream(args, engine, qs)
    f = stats["faults"]
    counts = kops.launch_counts()
    execs = engine.executors
    tag = tier_tag(label, execs[0].tiled_table)
    err, ties = 0.0, 0
    if adaptive is not None:
        err, ties = hold_runtime_dispatches(
            label, "pass 1 ", execs, untiled(execs[0], engine.n, engine.N),
            dispatches, adaptive)
    return {"fixed": {
        "outcomes": dict(sorted(stats["outcomes"].items())),
        "rungs_launched": sorted({r for r, _ in measured}),
        "served_per_rung": stats["degradation"]["served_per_rung"],
        "dispatches": stats["dispatches"],
        "dispatch_errors": f["dispatch_errors"],
        "injected_dispatch_errors": f["injected"]["dispatch_errors"]},
        "queries": raw,
        "launches": (counts[f"fused_cascade_batched[{tag}]"],
                     counts["fused_cascade_batched"]),
        "rung_dispatches": sum(ex.n_dispatches for ex in execs),
        "executors": len(execs), "held": len(dispatches),
        "max_abs_err": err, "near_ties": ties,
        "measured": measured, "seconds": time.perf_counter() - t0}


def runtime_run(label, precision, adaptive, bound) -> dict:
    """Phase 5: ``--loop --runtime`` under overload and injected faults,
    twice: pass 1 on `RUNTIME_DT` (`runtime_fixed_pass`), its counts
    held equal to the port's on the CPU at ``--smoke`` width through the
    plain route, all five outcomes and two rungs required, every
    dispatch held against the plain version; pass 2 on the measured
    dispatch times, every check that holds under any timing."""
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import serve

    tier = ["--precision", precision, "--bound", bound] + (
        ["--adaptive"] if adaptive else [])
    card = runtime_fixed_pass(RUNTIME_ARGV + tier, label,
                              adaptive=adaptive)
    cpu = runtime_fixed_pass(RUNTIME_ARGV + tier
                             + ["--smoke", "--device", "cpu"], label,
                             like=card["queries"])
    got, want = card["fixed"], cpu["fixed"]
    check(got == want, f"runtime {label} pass 1 (service time "
          f"{RUNTIME_DT * 1e3} ms): card {got} vs cpu {want}")
    o = got["outcomes"]
    check(all(o[s] > 0 for s in ("ok", "degraded", "overloaded",
                                 "rejected", "failed")),
          f"runtime {label} pass 1: an outcome is missing: {o}")
    check(len(got["rungs_launched"]) >= 2,
          f"runtime {label} pass 1: only rungs {got['rungs_launched']} "
          f"launched")
    check(card["launches"] == (card["rung_dispatches"],) * 2
          and card["rung_dispatches"] == card["executors"] + card["held"],
          f"runtime {label} pass 1: {card['launches']} launches of the "
          f"tier and in all for {card['rung_dispatches']} rung dispatches, "
          f"{card['held']} of them after warm-up held")
    check(got["dispatch_errors"] == got["injected_dispatch_errors"],
          f"runtime {label} pass 1: {got}")
    fixed = {**got, "service_ms": RUNTIME_DT * 1e3,
             "launches": card["launches"][0], "held": card["held"],
             "max_abs_err": card["max_abs_err"],
             "near_tie_queries": card["near_ties"],
             "measured_dispatch_ms_median_per_rung": [
                 statistics.median(s * 1e3 for r, s in card["measured"]
                                   if r == rung)
                 for rung in got["rungs_launched"]],
             "card_s": card["seconds"], "cpu_reference_s": cpu["seconds"]}
    say(f"runtime {label} pass 1: " + json.dumps(fixed))
    del card, cpu
    gc.collect()
    torch.cuda.empty_cache()

    t_pass = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    art = {k: str(Path(tmp.name) / f"{k}.{ext}") for k, ext in
           (("metrics", "prom"), ("trace", "json"), ("flight", "json"))}
    argv = RUNTIME_ARGV + tier + [
        "--metrics-out", art["metrics"], "--trace-out", art["trace"],
        "--flight-recorder-path", art["flight"]]
    args = serve.parse_args(argv)
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    engine, qs = serve.build_loop(args)
    execs = engine.executors
    N = engine.N
    qs = runtime_queries(qs, N)
    say(f"runtime {label}: table=({engine.n},{N}) rungs "
        f"{engine.ladder.eps_values} rounds "
        f"{[len(ex.plan.schedule.rounds) for ex in execs]} lanes "
        f"{engine.lanes} queue {args.queue_capacity}")
    name = (f"fused_cascade_batched"
            f"[{tier_tag(label, execs[0].tiled_table)}]")
    kops.reset_launch_counts()
    warm_s = engine.warmup()
    dispatches = []
    for rung, ex in enumerate(execs):
        def recording(Qbuf, perm, rung=rung, real=ex.dispatch):
            out = real(Qbuf, perm)
            dispatches.append((rung, Qbuf.copy(), perm, out))
            return out
        ex.dispatch = recording
    t0 = time.perf_counter()
    stats = serve.serve_stream(args, engine, qs)
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts = kops.launch_counts()
    n_disp = sum(ex.n_dispatches for ex in execs)
    check(counts[name] == n_disp == counts["fused_cascade_batched"]
          and n_disp == len(execs) + len(dispatches),
          f"runtime {label}: {counts[name]} {name} launches "
          f"({counts['fused_cascade_batched']} in all) for {n_disp} rung "
          f"dispatches, {len(dispatches)} of them after warm-up")
    try:
        serve.check_outcomes(args, stats)
    except SystemExit as e:
        raise SmokeFailure(f"runtime {label}: {e}") from None
    o = stats["outcomes"]
    rungs = sorted({r for r, *_ in dispatches})
    f = stats["faults"]
    check(f["dispatch_errors"] == f["injected"]["dispatch_errors"],
          f"runtime {label}: {f['dispatch_errors']} dispatch errors, "
          f"{f['injected']['dispatch_errors']} of them injected")
    table = untiled(execs[0], engine.n, N)
    err, ties = hold_runtime_dispatches(label, "", execs, table, dispatches,
                                        adaptive)
    answered = 0
    for rid in range(args.requests):
        res = engine.result(rid)
        check(res is not None, f"runtime {label}: request {rid} has no "
              f"result")
        if res.answered:
            answered += 1
            check_served(table, qs[rid], res.ids, res.scores,
                         execs[0].n_valid, f"runtime {label}: request {rid}")
    obs = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "check_obs_artifacts.py"),
         "--metrics", art["metrics"], "--trace", art["trace"],
         "--flight", art["flight"]], capture_output=True, text=True)
    check(obs.returncode == 0, f"runtime {label}: obs artifacts: "
          f"{obs.stdout.strip()} {obs.stderr.strip()}")
    tmp.cleanup()
    lat, lanes = stats["latency_ms"], stats["lanes"]
    res = {"launches": counts[name] + fixed["launches"],
           "pass2_launches": counts[name],
           "dispatches": stats["dispatches"],
           "rungs_launched": rungs,
           "max_abs_err": max(err, fixed["max_abs_err"]),
           "pass2_max_abs_err": err,
           "near_tie_queries": ties, "answered": answered,
           "p50_ms": lat["p50"], "p95_ms": lat["p95"], "p99_ms": lat["p99"],
           "throughput_rps": stats["throughput_rps"],
           "virtual_s": stats["virtual_s"], "outcomes": o,
           "served_per_rung": stats["degradation"]["served_per_rung"],
           "mean_lane_util": lanes["mean_lane_util"],
           "mean_executed_pull_frac": lanes["mean_executed_pull_frac"],
           "retries": f["retries"], "failed_batches": f["failed_batches"],
           "injected": {k: f["injected"][k] for k in (
               "latency_spikes", "injected_latency_ms", "dispatch_errors",
               "persistent_errors")},
           "dispatch_ms_median_per_rung": [
               statistics.median(o[3] * 1e3 for r, _, _, o in dispatches
                                 if r == rung) for rung in rungs],
           "speedup_per_rung": [ex.plan.schedule.speedup for ex in execs],
           "mem_before_gb": base_gb, "peak_mem_gb": peak_gb,
           "warmup_s": warm_s, "wall_s": wall,
           "pass2_s": time.perf_counter() - t_pass, "fixed": fixed}
    say(f"runtime {label}: " + json.dumps(res))
    return res


class TiledRows:
    """Row ``i`` of a store's tiled table as it stands, indexed the way
    `compare` indexes a table (no row-major copy is made)."""

    def __init__(self, store):
        self.store = store

    def __getitem__(self, i):
        st = self.store
        return st.tiled_table()[i // st.tile, :, i % st.tile, :].reshape(
            -1)[:st.N]


def stage_script(store, rng, n_ops: int) -> None:
    """Stage ``n_ops`` seeded mutations, in turn an upsert of a live id, a
    delete + append pair and an append, of N(0, 0.02) rows like the
    table's."""
    for k in range(n_ops):
        row = (0.02 * rng.standard_normal(store.N)).astype(np.float32)
        live = store.live_ids()
        if k % 3 == 0:
            store.upsert(int(rng.choice(live)), row)
        elif k % 3 == 1:
            store.delete(int(rng.choice(live)))
            store.append(row)
        else:
            store.append(row)


def store_buffers(store) -> dict:
    bufs = {"tiled": store.tiled_table()}
    if store.quantized() is not None:
        bufs.update(zip(("codes", "aux"), store.quantized()))
    return bufs


def store_only(label: str, rows: np.ndarray) -> dict:
    """Phase 6a: a store of the vocab rows on the card, a seeded script of
    mutations in bursts; after each burst its buffers are bytewise a
    fresh store's built from its snapshot, no buffer moved and no
    schedule was built."""
    from repro_torch.core.boundedme_torch import schedule_operands
    from repro_torch.store import DynamicTableStore
    kw = dict(block=512, precision=label, pq_subdims=8, pq_codes=16,
              device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = DynamicTableStore(rows, capacity_slack=STORE_SLACK, **kw)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ptrs = {k: v.data_ptr() for k, v in store_buffers(st).items()}
    builds = schedule_operands.cache_info().misses
    rng = np.random.default_rng(17)
    infos, fresh_s = [], []
    for burst in range(STORE_BURSTS):
        stage_script(st, rng, STORE_OPS // STORE_BURSTS)
        infos.append(st.flush_updates())
        t0 = time.perf_counter()
        snap, ids = st.snapshot()
        fresh = DynamicTableStore(
            snap, ids=ids, capacity=st.capacity_rows,
            codebook=st.codebook() if label == "pq" else None, **kw)
        torch.cuda.synchronize()
        fresh_s.append(time.perf_counter() - t0)
        check(np.array_equal(st.host_table(), fresh.host_table()),
              f"store {label} burst {burst}: host mirror differs from a "
              f"fresh store's")
        mine, theirs = store_buffers(st), store_buffers(fresh)
        for name, buf in mine.items():
            check(torch.equal(buf, theirs[name]),
                  f"store {label} burst {burst}: {name} differs from a "
                  f"fresh store's")
            check(buf.data_ptr() == ptrs[name],
                  f"store {label} burst {burst}: {name} was reallocated")
        del fresh, theirs, snap
    check(schedule_operands.cache_info().misses == builds,
          f"store {label}: the mutation stream built a schedule")
    secs = [i["seconds"] for i in infos]
    res = {"capacity_rows": st.capacity_rows, "n_live": st.n_live,
           "build_s": build_s, "flushes": len(infos),
           "rows_applied": sum(i["applied"] for i in infos),
           "tiles_reencoded": sum(i["requantized_tiles"] for i in infos),
           "flush_s_total": sum(secs), "flush_ms_median":
               1e3 * statistics.median(secs), "flush_ms_max": 1e3 * max(secs),
           "fresh_build_s_median": statistics.median(fresh_s),
           "resident_gb": st.resident_bytes() / 1e9,
           "bytewise_fresh": True, "buffers_moved": 0, "schedules_built": 0}
    say(f"store {label}: " + json.dumps(res))
    del st
    torch.cuda.empty_cache()
    return res


def store_runtime_run(label, precision, adaptive, bound, static,
                      extra=()) -> dict:
    """Phase 6b-c: ``--loop --runtime --dynamic`` under churn and flush
    faults, every dispatch held before the next flush; then growth."""
    from repro_torch.core.boundedme_torch import decode_tiled
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.fused_cascade import launch_grid
    from repro_torch.launch import serve

    tmp = tempfile.TemporaryDirectory()
    art = {k: str(Path(tmp.name) / f"{k}.{ext}") for k, ext in
           (("metrics", "prom"), ("trace", "json"), ("flight", "json"))}
    argv = STORE_ARGV + [
        "--precision", precision, "--bound", bound,
        "--metrics-out", art["metrics"], "--trace-out", art["trace"],
        "--flight-recorder-path", art["flight"], *extra] + (
            ["--adaptive"] if adaptive else [])
    args = serve.parse_args(argv)
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    engine, qs = serve.build_loop(args)
    store, execs = engine.store, engine.executors
    check(store is not None and all(ex.store is store for ex in execs)
          and all(ex.tiled_table is store.tiled_table() for ex in execs),
          f"store runtime {label}: rungs do not share the store's table")
    qs = list(qs)
    N = engine.N
    for i, bad in zip((5, 70, 140, 210), (
            np.full(N, np.nan, np.float32), np.full(N, np.inf, np.float32),
            np.ones(N + 1, np.float32), np.ones(N - 3, np.float32))):
        qs[i] = bad
    grid, capacity = launch_grid(torch.device(DEV))
    keys = []
    for ex in execs:
        rounds = ex.plan.schedule.rounds
        n_final = rounds[-1].n_keep if rounds else ex.plan.n_tiles
        P = max(ex.plan.n_tiles, n_final * ex.plan.tile)
        keys.append({"P": P, "capacity": capacity,
                     "workspace": P > capacity,
                     "workspace_mb": 8 * grid * P / 1e6 if P > capacity
                     else 0.0})
    say(f"store runtime {label}: table=({engine.n},{N}) live "
        f"{store.n_live} rungs {engine.ladder.eps_values} rounds "
        f"{[len(ex.plan.schedule.rounds) for ex in execs]} keys {keys}")
    name = f"fused_cascade_batched[{label}]"
    kops.reset_launch_counts()
    warm_s = engine.warmup()
    flushes = []
    real_flush = store.flush_updates

    def recording_flush():
        info = real_flush()
        flushes.append(info)
        return info
    store.flush_updates = recording_flush
    rows = TiledRows(store)
    checked = []
    for rung, ex in enumerate(execs):
        def checking(Qbuf, perm, rung=rung, ex=ex, real=ex.dispatch):
            out = real(Qbuf, perm)
            # held now, before the next flush can change the table
            Q = torch.from_numpy(Qbuf).to(DEV)
            with plain_route():
                ref = decode_tiled(ex.tiled_table, Q, perm, plan=ex.plan,
                                   final_exact=True, n_valid=ex.n_valid,
                                   quantized=ex.quantized,
                                   adaptive=adaptive)
            got = [torch.from_numpy(t) for t in out[:3 if adaptive else 2]]
            r = compare(rows, Q, got, ref,
                        what=f"store runtime {label} rung {rung} dispatch "
                        f"{len(checked)}")
            host = store.host_table()
            for i in np.flatnonzero(np.abs(Qbuf).sum(1) > 0):
                slots = out[0][i]
                check(len(set(slots.tolist())) == K
                      and int(slots.max()) < store.n_live
                      and (store.external_ids(slots) >= 0).all(),
                      f"store runtime {label}: lane {i} slots "
                      f"{slots.tolist()} with {store.n_live} live rows")
                exact = host[slots].astype(np.float64) @ Qbuf[i].astype(
                    np.float64) / N
                check(np.allclose(out[1][i], exact, rtol=EXACT_RTOL, atol=0),
                      f"store runtime {label}: lane {i} scores "
                      f"{out[1][i].tolist()} vs exact {exact.tolist()}")
            checked.append((rung, out[3], r["max_abs_err"],
                            r["near_tie_queries"]))
            return out
        ex.dispatch = checking
    t0 = time.perf_counter()
    stats = serve.serve_stream(args, engine, qs)
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts = kops.launch_counts()
    n_disp = sum(ex.n_dispatches for ex in execs)
    check(counts[name] == n_disp == counts["fused_cascade_batched"]
          and n_disp == len(execs) + len(checked),
          f"store runtime {label}: {counts[name]} {name} launches "
          f"({counts['fused_cascade_batched']} in all) for {n_disp} rung "
          f"dispatches, {len(checked)} of them after warm-up")
    try:
        serve.check_outcomes(args, stats)
    except SystemExit as e:
        raise SmokeFailure(f"store runtime {label}: {e}") from None
    f = stats["faults"]
    check(f["store_flush_failures"] == f["injected"]["flush_failures"]
          == store.n_flush_failures > 0 and f["update_errors"] == 0,
          f"store runtime {label}: {f['store_flush_failures']} flush "
          f"failures, {f['injected']['flush_failures']} injected, "
          f"{f['update_errors']} update errors")
    check(f["dispatch_errors"] == f["injected"]["dispatch_errors"],
          f"store runtime {label}: {f['dispatch_errors']} dispatch errors, "
          f"{f['injected']['dispatch_errors']} of them injected")
    check(stats["updates"]["applied"] > 0,
          f"store runtime {label}: updates {stats['updates']}")
    obs = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "check_obs_artifacts.py"),
         "--metrics", art["metrics"], "--trace", art["trace"],
         "--flight", art["flight"]], capture_output=True, text=True)
    check(obs.returncode == 0, f"store runtime {label}: obs artifacts: "
          f"{obs.stdout.strip()} {obs.stderr.strip()}")
    tmp.cleanup()
    stream_launches = counts[name]

    # growth: a row 40x the table's largest norm along a served query
    # (faults off), then grow() to a larger slack; each rung rebuilds
    engine.injector = None
    store.fault_hook = None
    store.flush_updates = real_flush
    norms = np.linalg.norm(store.host_table()[:store.n_live], axis=1)
    answered = [rid for rid in range(args.requests)
                if engine.result(rid).answered]
    q = np.asarray(qs[answered[0]], np.float32)
    new_id = store.append((40.0 * float(norms.max()) * q
                           / np.linalg.norm(q)).astype(np.float32))
    t = stats["virtual_s"] + 1.0
    growth = {}
    kops.reset_launch_counts()
    for step, grow_to in (("value_range", None),
                          ("capacity", STORE_GROWN_SLACK)):
        if grow_to is not None:
            store.grow(int(np.ceil(store.n_live * grow_to)))
        recal = [ex.n_recalibrations for ex in execs]
        before = len(checked)
        rid = engine.submit(q, now=t)
        engine.drain(now=t)
        t += 1.0
        res = engine.result(rid)
        check(res is not None and res.answered and new_id in res.ids,
              f"store runtime {label} {step} growth: {res}")
        check([ex.n_recalibrations for ex in execs] == [r + 1 for r in recal],
              f"store runtime {label} {step} growth: recalibrations "
              f"{recal} -> {[ex.n_recalibrations for ex in execs]}")
        check(len(checked) == before + 1, f"store runtime {label} {step} "
              f"growth: {len(checked) - before} dispatches")
        growth[step] = {"capacity_rows": store.capacity_rows,
                        "rounds": len(execs[0].plan.schedule.rounds),
                        "dispatch_ms": 1e3 * checked[-1][1],
                        "max_abs_err": checked[-1][2]}
    growth_launches = kops.launch_counts()[name]
    check(growth_launches == 2, f"store runtime {label}: {growth_launches} "
          f"{name} launches for the 2 growth dispatches")
    secs = [i["seconds"] for i in flushes]
    lat = stats["latency_ms"]
    rungs = sorted({c[0] for c in checked[:-2]})
    res = {"launches": stream_launches + growth_launches,
           "stream_launches": stream_launches,
           "dispatches": stats["dispatches"], "held_dispatches": len(checked),
           "max_abs_err": max(c[2] for c in checked),
           "near_tie_queries": sum(c[3] for c in checked),
           "outcomes": stats["outcomes"], "p50_ms": lat["p50"],
           "p95_ms": lat["p95"], "p99_ms": lat["p99"],
           "throughput_rps": stats["throughput_rps"],
           "virtual_s": stats["virtual_s"],
           "served_per_rung": stats["degradation"]["served_per_rung"],
           "flushes": len(flushes), "flush_failures": f["store_flush_failures"],
           "rows_applied": stats["updates"]["applied"],
           "tiles_reencoded": stats["store"]["tiles_requantized"],
           "flush_ms_median": 1e3 * statistics.median(secs) if secs else 0.0,
           "flush_ms_max": 1e3 * max(secs) if secs else 0.0,
           "flush_s_total": sum(secs),
           "dispatch_ms_median_per_rung": [
               1e3 * statistics.median(c[1] for c in checked[:-2]
                                       if c[0] == rung) for rung in rungs],
           "rungs_launched": rungs,
           "static_dispatch_ms_median_per_rung": static,
           "keys": keys, "growth": growth,
           "mem_before_gb": base_gb, "peak_mem_gb": peak_gb,
           "warmup_s": warm_s, "wall_s": wall}
    say(f"store runtime {label}: " + json.dumps(res))
    return res


def keys_branch_cost(rows: np.ndarray) -> dict:
    """Kernel 1 (fp32, B = 4, row mode) over two stores of the vocab rows:
    at the largest capacity whose round-end keys fit a CTA's shared
    memory, and at the default slack's, whose keys go to the device
    workspace; each held against the plain version, then timed in turns
    (three each, alternating which runs first)."""
    from repro_torch.core.boundedme_torch import make_plan
    from repro_torch.kernels.fused_cascade import (fused_cascade_batched_cuda,
                                                   launch_grid)
    from repro_torch.kernels.ref import fused_cascade_batched_ref
    from repro_torch.launch.engine import seeded_perm
    from repro_torch.store import DynamicTableStore
    _, cap = launch_grid(torch.device(DEV))
    n, N = rows.shape
    Q = torch.from_numpy(np.random.default_rng(1234).normal(
        size=(B, N)).astype(np.float32)).to(DEV)
    cases = {}
    for label, capacity in (("shared", 8 * cap),
                            ("workspace", int(np.ceil(n * STORE_SLACK)))):
        st = DynamicTableStore(rows, capacity=capacity, block=512,
                               device=DEV)
        plan = make_plan(st.capacity_rows, N, K=K, eps=EPS, delta=DELTA,
                         value_range=2.0 * st.value_abs_max)
        ops, kw = cascade_operands(plan, st.tiled_table(), Q,
                                   seeded_perm(0, 0, plan.n_blocks))
        P = max(plan.n_tiles, kw["n_final"] * plan.tile)
        check((P > cap) == (label == "workspace"),
              f"keys {label}: P {P} against capacity {cap}")
        got = fused_cascade_batched_cuda(*ops, n_valid=st.n_live, **kw)
        ref = fused_cascade_batched_ref(*ops, n_valid=st.n_live, **kw)
        r = compare(TiledRows(st), Q, got, ref, what=f"keys {label}")
        cases[label] = (st, ops, kw, {"capacity_rows": st.capacity_rows,
                                      "n_tiles": plan.n_tiles, "P": P,
                                      "key_capacity": cap,
                                      "max_abs_err": r["max_abs_err"]})
    runs = {label: [] for label in cases}
    for i in range(6):
        label = ("shared", "workspace", "workspace", "shared")[i % 4]
        st, ops, kw, _ = cases[label]
        runs[label].append(time_cuda(lambda: fused_cascade_batched_cuda(
            *ops, n_valid=st.n_live, **kw), 10, 2))
    out = {label: dict(info, kernel_ms_runs=runs[label],
                       kernel_ms=statistics.median(runs[label]))
           for label, (_, _, _, info) in cases.items()}
    say("store keys branch: " + json.dumps(out))
    return out


def phase_store(table, n_valid, runtime) -> dict:
    """Phase 6: the live-corpus store on the full vocab table."""
    rows = table[:n_valid].cpu().numpy()
    out = {"only": {}, "runtime": {}}
    for label in STORE_TIERS:
        out["only"][label] = store_only(label, rows)
    out["keys_branch"] = keys_branch_cost(rows)
    torch.cuda.empty_cache()
    del rows
    static = {k: v["dispatch_ms_median_per_rung"] for k, v in runtime.items()}
    for tier in STORE_RUNTIME_TIERS:
        out["runtime"][tier[0]] = store_runtime_run(*tier, static)
        torch.cuda.empty_cache()
    return out


def tenant_bytes(rows: int, precision: str, N: int = 1024,
                 block: int = 512, tile: int = 8) -> int:
    """Device bytes of a tenant's store at slack 1.5, from its geometry:
    the tiled f32 table plus the int8 / int4 codes and their scales."""
    cap = -(-int(np.ceil(rows * 1.5)) // tile) * tile
    block = min(block, N)
    n_blocks = -(-N // block)
    total = cap * n_blocks * block * 4
    if precision in ("int8", "int4"):
        total += (cap * n_blocks * block // (1 if precision == "int8" else 2)
                  + cap // tile * n_blocks * 4)
    return total


def phase_tenancy() -> dict:
    """Phase 7: ``--loop --tenants`` on the card, one run per stream of
    `TENANCY_STREAMS`; the launches and errors of both for the kernels
    line."""
    runs = {}
    for spacing, every_tenant in TENANCY_STREAMS:
        runs[spacing] = tenancy_run(spacing, every_tenant)
        gc.collect()        # the runtime's closures hold its stores
        torch.cuda.empty_cache()
    tiers = {t for r in runs.values() for t in r["launches"]}
    return {"runs": runs,
            "launches": {t: sum(r["launches"].get(t, 0)
                                for r in runs.values()) for t in tiers},
            "max_abs_err": {t: max(r["max_abs_err"].get(t, 0.0)
                                   for r in runs.values()) for t in tiers}}


def tenancy_run(spacing: str, every_tenant: bool) -> dict:
    """One ``--loop --tenants`` stream at base spacing ``spacing`` ms:
    four f32 stores under a device byte budget that cannot hold both
    cold tables beside the others, the runtime phase's stream settings,
    faults on, a burst of mutations on ``items`` mid-stream; every
    dispatch held, every page checked, one tenant replayed through a
    dedicated runtime."""
    from repro_torch.core.boundedme_torch import decode_tiled
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import serve
    from repro_torch.launch.engine import CascadeExecutor, ServeRuntime
    from repro_torch.launch.tenancy import TableRegistry
    from repro_torch.store import DynamicTableStore

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    art = {k: str(Path(tmp.name) / f"{k}.{ext}") for k, ext in
           (("metrics", "prom"), ("trace", "json"), ("flight", "json"))}
    spec = {name: {"rows": rows, "precision": tier, "rate_factor": rate,
                   **({"eps_floor": floor} if floor else {})}
            for name, rows, tier, rate, floor in TENANTS}
    spec_path = Path(tmp.name) / "tenants.json"
    spec_path.write_text(json.dumps({"tenants": spec}))
    args = serve.parse_args(TENANCY_ARGV + [
        "--interarrival-ms", spacing,
        "--tenants", str(spec_path), "--metrics-out", art["metrics"],
        "--trace-out", art["trace"], "--flight-recorder-path",
        art["flight"]])
    dim = serve.decode_config(args).d_model
    nbytes = {name: tenant_bytes(rows, tier, N=dim)
              for name, rows, tier, _, _ in TENANTS}
    args.table_budget_mb = 1.05 * (nbytes["vocab"] + nbytes["items"]
                                   + nbytes["cold_b"]) / 2**20

    # registry hooks: each registered table's buffers kept on the card
    # (outside the budget) to hold every page-in against; card memory
    # read around every eviction; resident bytes after every change
    expected, stores = {}, {}
    log = {"evictions": [], "page_ins": [], "max_resident": 0,
           "streaming": False, "flushes": []}
    real = {k: getattr(TableRegistry, k)
            for k in ("register", "evict", "ensure_resident")}
    real_dispatch = CascadeExecutor.dispatch

    def budget_held(reg):
        log["max_resident"] = max(log["max_resident"], reg.resident_bytes())
        check(reg.resident_bytes() <= reg.byte_budget,
              f"tenancy: {reg.resident_bytes()} resident bytes past the "
              f"budget {reg.byte_budget}")

    def keep(name, store):
        expected[name] = {k: v.clone()
                          for k, v in store_buffers(store).items()}

    def register(self, name, table, config=None, **kw):
        store = real["register"](self, name, table, config, **kw)
        check(store.resident_bytes() == nbytes[name],
              f"tenancy {name}: {store.resident_bytes()} bytes, the "
              f"geometry gives {nbytes[name]}")
        stores[name] = store
        keep(name, store)
        budget_held(self)
        return store

    def evict(self, name):
        entry = self._entry(name)
        was = entry.resident
        before = torch.cuda.memory_allocated()
        real["evict"](self, name)
        if was:
            freed = before - torch.cuda.memory_allocated()
            check(freed >= entry.nbytes, f"tenancy: evicting {name} freed "
                  f"{freed} bytes of card memory, not its {entry.nbytes}")
            log["evictions"].append({"tenant": name, "bytes": entry.nbytes,
                                     "freed": freed,
                                     "in_stream": log["streaming"]})

    def ensure_resident(self, name):
        dt = real["ensure_resident"](self, name)
        if dt > 0.0:
            got = store_buffers(self._entry(name).store)
            check(got.keys() == expected[name].keys() and all(
                torch.equal(v, expected[name][k]) for k, v in got.items()),
                f"tenancy: {name} paged in with buffers other than it "
                f"was paged out with")
            log["page_ins"].append({"tenant": name, "ms": dt * 1e3,
                                    "bytes": self.table_bytes(name),
                                    "in_stream": log["streaming"]})
        budget_held(self)
        return dt

    checked, replay, perm_of, after_warm = [], [], {}, {}

    def dispatch(self, Qbuf, perm):
        out = real_dispatch(self, Qbuf, perm)
        tenant = self._mlabels.get("tenant")
        if tenant is None:
            return out
        rung = int(self._mlabels["rung"])
        store = self.store
        warm = not bool(np.abs(Qbuf).any())
        Q = torch.from_numpy(Qbuf).to(DEV)
        with plain_route():
            ref = decode_tiled(self.tiled_table, Q, perm, plan=self.plan,
                               final_exact=True, n_valid=self.n_valid,
                               quantized=self.quantized)
        r = compare(TiledRows(store), Q,
                    [torch.from_numpy(out[0]), torch.from_numpy(out[1])],
                    ref, what=f"tenancy {tenant} rung {rung} dispatch "
                    f"{len(checked)}")
        host = store.host_table()
        for i in np.flatnonzero(np.abs(Qbuf).sum(1) > 0):
            slots = out[0][i]
            check(len(set(slots.tolist())) == K
                  and int(slots.max()) < store.n_live
                  and (store.external_ids(slots) >= 0).all(),
                  f"tenancy {tenant}: lane {i} slots {slots.tolist()} with "
                  f"{store.n_live} live rows")
            exact = host[slots].astype(np.float64) @ Qbuf[i].astype(
                np.float64) / store.N
            check(np.allclose(out[1][i], exact, rtol=EXACT_RTOL, atol=0),
                  f"tenancy {tenant}: lane {i} scores {out[1][i].tolist()} "
                  f"vs exact {exact.tolist()}")
        didx = None if warm else perm_of[id(perm)][1]
        if warm:
            after_warm[tenant] = after_warm.get(tenant, []) + [None]
        elif after_warm.get(tenant) and after_warm[tenant][-1] is None:
            after_warm[tenant][-1] = out[3] * 1e3
        checked.append({"tenant": tenant, "rung": rung, "warm": warm,
                        "didx": didx, "tier": self.plan.precision,
                        "ms": out[3] * 1e3, "err": r["max_abs_err"],
                        "ties": r["near_tie_queries"]})
        if tenant == TENANCY_REPLAY and not warm:
            replay.append((didx, rung, Qbuf.copy(), perm, out[0].copy(),
                           out[1].copy()))
        return out

    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    TableRegistry.register, TableRegistry.evict = register, evict
    TableRegistry.ensure_resident = ensure_resident
    CascadeExecutor.dispatch = dispatch
    try:
        t0 = time.perf_counter()
        engine, qs, trace, labels = serve.build_tenants(args)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        reg = engine.registry
        real_perm = engine._perm_source

        def perm_source(tenant, didx, n_blocks):
            perm = real_perm(tenant, didx, n_blocks)
            perm_of[id(perm)] = (tenant, didx, perm)   # keeps the id live
            return perm
        engine._perm_source = perm_source
        items = stores["items"]
        real_flush = items.flush_updates

        def flush():
            info = real_flush()
            keep("items", items)
            log["flushes"].append(info)
            return info
        items.flush_updates = flush
        burst_rng = np.random.default_rng(29)
        staged = []

        def churn(eng, i):
            if i == len(trace) // 2:
                before = items.pending_updates
                stage_script(items, burst_rng, TENANCY_BURST)
                staged.append(items.pending_updates - before)
        say(f"tenancy: {len(TENANTS)} tables built in {build_s:.2f} s, "
            f"bytes {nbytes}, budget {reg.byte_budget}, resident "
            f"{[n for n in reg.tenants() if reg.is_resident(n)]}, "
            f"{len(trace)} arrivals")
        kops.reset_launch_counts()
        warm_s = engine.warmup()
        log["streaming"] = True
        t0 = time.perf_counter()
        stats = serve.serve_tenants(args, engine, qs, trace, labels,
                                    churn=churn)
        wall = time.perf_counter() - t0
        log["streaming"] = False
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        counts = kops.launch_counts()
    finally:
        TableRegistry.register, TableRegistry.evict = (real["register"],
                                                       real["evict"])
        TableRegistry.ensure_resident = real["ensure_resident"]
        CascadeExecutor.dispatch = real_dispatch

    try:
        serve.check_outcomes(args, stats)
    except SystemExit as e:
        raise SmokeFailure(f"tenancy: {e}") from None
    names = [t[0] for t in TENANTS]
    obs = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "check_obs_artifacts.py"),
         "--metrics", art["metrics"], "--trace", art["trace"],
         "--flight", art["flight"], "--expect-tenants", ",".join(names)],
        capture_output=True, text=True)
    check(obs.returncode == 0, f"tenancy: obs artifacts: "
          f"{obs.stdout.strip()} {obs.stderr.strip()}")
    flight = json.loads(Path(art["flight"]).read_text())["events"]
    tmp.cleanup()
    outs = {e["in_stream"] for e in log["evictions"]}
    ins = {e["in_stream"] for e in log["page_ins"]}
    check(True in outs and True in ins, f"tenancy: no page-out or no "
          f"page-in in the stream ({len(log['evictions'])} out, "
          f"{len(log['page_ins'])} in)")
    per = stats["tenants"]
    for name in names:
        t = per[name]
        check(not every_tenant
              or t["outcomes"]["ok"] + t["outcomes"]["degraded"] > 0,
              f"tenancy {name}: no request answered: {t['outcomes']}")
        check(t["queue"]["peak_depth"] <= t["queue"]["capacity"],
              f"tenancy {name}: queue peak {t['queue']['peak_depth']} past "
              f"its capacity {t['queue']['capacity']}")
    check(staged and log["flushes"] and sum(
        f["applied"] for f in log["flushes"]) == staged[0]
        and stats["faults"]["update_errors"] == 0,
        f"tenancy: {staged} staged on items, flushes {log['flushes']}")
    check(stats["faults"]["dispatch_errors"]
          == stats["faults"]["injected"]["dispatch_errors"],
          f"tenancy: {stats['faults']['dispatch_errors']} dispatch errors, "
          f"{stats['faults']['injected']['dispatch_errors']} injected")
    dispatched = {}
    for labels_, value in engine.metrics.get(
            "cascade_dispatches_total").rows():
        tier = labels_["precision"]
        dispatched[tier] = dispatched.get(tier, 0) + int(value)
    for tier, n in dispatched.items():
        name = f"fused_cascade_batched[{tier}]"
        check(counts[name] == n == sum(1 for c in checked
                                       if c["tier"] == tier),
              f"tenancy: {counts[name]} {name} launches for {n} executor "
              f"dispatches")
    check(counts["fused_cascade_batched"] == sum(dispatched.values()),
          f"tenancy: {counts['fused_cascade_batched']} launches in all for "
          f"{dispatched}")

    # the replay: one tenant's dispatches through a dedicated runtime on a
    # store of the same rows, under its own seed's permutations
    vstore = stores[TENANCY_REPLAY]
    rows, ids = vstore.snapshot()
    cfg = reg.config(TENANCY_REPLAY)
    dedicated = ServeRuntime(
        DynamicTableStore(rows, ids=ids, capacity=vstore.capacity_rows,
                          block=cfg.block, precision=cfg.precision,
                          device=DEV),
        K=cfg.K, eps=cfg.eps, delta=cfg.delta, eps_floor=cfg.eps_floor,
        degrade_rungs=cfg.degrade_rungs, degrade_start=cfg.degrade_start,
        lanes=args.batch, batch_wait_ms=args.deadline_ms,
        queue_capacity=cfg.queue_capacity, classes=cfg.priority_classes(),
        precision=cfg.precision, pull_mode=cfg.pull_mode,
        cache_entries=cfg.cache_entries, seed=cfg.seed, device=DEV)
    check(torch.equal(dedicated.store.tiled_table(),
                      expected[TENANCY_REPLAY]["tiled"]),
          "tenancy replay: the dedicated store differs from the tenant's")
    for didx, rung, Qbuf, perm, ids_, scores_ in replay:
        ex = dedicated.executors[rung]
        p = dedicated._perm_source(didx, ex.plan.n_blocks)
        got = ex.dispatch(Qbuf, p)
        check(torch.equal(torch.as_tensor(p), torch.as_tensor(perm))
              and np.array_equal(got[0], ids_)
              and np.array_equal(got[1], scores_),
              f"tenancy replay: {TENANCY_REPLAY} dispatch {didx} differs "
              f"from the dedicated runtime's")
    check(len(replay) > 0, "tenancy replay: nothing to replay")
    del dedicated, expected
    torch.cuda.empty_cache()

    served = [c for c in checked if not c["warm"]]
    rebuilds = {}
    for e in flight:
        if e["kind"] == "executor_rebuild":
            rebuilds.setdefault(e["tenant"], []).append(
                (e["cause"], round(e["warm_ms"], 3)))
    res = {
        "launches": {t: counts[f"fused_cascade_batched[{t}]"]
                     for t in dispatched},
        "max_abs_err": {t: max(c["err"] for c in checked if c["tier"] == t)
                        for t in dispatched},
        "near_tie_queries": sum(c["ties"] for c in checked),
        "held_dispatches": len(checked), "warm_dispatches": len(checked)
        - len(served), "replayed": len(replay),
        "tenants": {n: {"requests": per[n]["requests"],
                        "outcomes": per[n]["outcomes"],
                        "p50_ms": per[n]["latency_ms"]["p50"],
                        "p99_ms": per[n]["latency_ms"]["p99"],
                        "served_per_rung": [
                            int(engine._c_rung.get(tenant=n, rung=str(i)))
                            for i in range(engine._state(n).ladder.n_rungs)],
                        "executor_builds": reg.executor_builds(n)}
                    for n in names},
        "outcomes": stats["outcomes"], "p50_ms": stats["latency_ms"]["p50"],
        "p99_ms": stats["latency_ms"]["p99"],
        "throughput_rps": stats["throughput_rps"],
        "virtual_s": stats["virtual_s"],
        "page_outs": [(e["tenant"], e["in_stream"])
                      for e in log["evictions"]],
        "page_ins_ms": [(e["tenant"], round(e["ms"], 3), e["in_stream"])
                        for e in log["page_ins"]],
        "page_in_gb_per_s": [round(e["bytes"] / e["ms"] / 1e6, 2)
                             for e in log["page_ins"]],
        "freed_over_bytes": min(e["freed"] / e["bytes"]
                                for e in log["evictions"]),
        "rebuilds": rebuilds,
        "first_dispatch_after_warm_ms": {
            t: [round(v, 3) for v in vs if v is not None]
            for t, vs in after_warm.items()},
        "dispatch_ms_median_per_tier": {
            t: statistics.median([c["ms"] for c in served
                                  if c["tier"] == t] or [0.0])
            for t in dispatched},
        "flushes": [(f["applied"], f["requantized_tiles"],
                     round(1e3 * f["seconds"], 3)) for f in log["flushes"]],
        "budget": reg.byte_budget, "max_resident": log["max_resident"],
        "resident_end": reg.resident_bytes(), "table_bytes": nbytes,
        "mem_before_gb": base_gb, "peak_mem_gb": peak_gb,
        "reference_copies_gb": sum(nbytes.values()) / 1e9,
        "build_s": build_s, "warmup_s": warm_s, "wall_s": wall,
        "phase_s": time.perf_counter() - t_phase}
    say(f"tenancy {spacing} ms: " + json.dumps(res))
    return res


def mips_run(V, Q, label, precision, adaptive, bound, mode, quant_err,
             exact_ids) -> dict:
    """One tier's queries through ``mips_topk``, launches counted."""
    from repro_torch.core import mips
    from repro_torch.kernels import ops as kops
    n, N = V.shape
    kw = dict(eps=EPS, delta=DELTA, final_exact=True, precision=precision,
              adaptive=adaptive, bound=bound, pull_mode=mode,
              quant_err=quant_err)
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    outs = [mips.mips_topk(V, q, K, device=DEV, **kw) for q in Q]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kops.launch_counts()
    name = "fused_cascade" + ("" if label == "fp32" else f"[{label}]")
    check(counts[f"fused_cascade[{label}]"] == len(Q)
          and counts["fused_cascade"] == len(Q)
          and counts["fused_cascade_batched"] == 0,
          f"mips {label} {mode}: launches {counts[f'fused_cascade[{label}]']}"
          f" of fused_cascade[{label}] ({counts['fused_cascade']} in all) "
          f"for {len(Q)} calls")
    hits = 0
    for b, (ids, scores) in enumerate(outs):
        ids_l = ids.tolist()
        check(len(set(ids_l)) == K and max(ids_l) < n and min(ids_l) >= 0,
              f"mips {label} {mode}: query {b} ids {ids_l}")
        exact = (V[ids.long()].double() @ Q[b].double()) / N
        check(torch.allclose(scores.double(), exact, rtol=EXACT_RTOL,
                             atol=0.0),
              f"mips {label} {mode}: query {b} scores {scores.tolist()} vs "
              f"exact {exact.tolist()}")
        hits += len(set(ids_l) & set(exact_ids[b]))
    res = {"name": name, "calls": len(Q),
           "launches": counts[f"fused_cascade[{label}]"],
           "recall": hits / (K * len(Q)), "wall_s": wall,
           "ms_per_call": 1e3 * wall / len(Q)}
    say(f"mips {label} {mode}: " + json.dumps(res))
    return res, outs


def phase_mips(table, n_valid) -> dict:
    """Phase 8: the library API on the unpadded vocab table."""
    from repro_torch.core import mips
    from repro_torch.core.boundedme_torch import (bounded_me_batched,
                                                  bounded_me_blocked,
                                                  draw_perms, make_plan,
                                                  measured_plan_quant_err,
                                                  tile_table)
    from repro_torch.kernels import ops as kops

    V = table[:n_valid]                    # the unpadded vocab table
    n, N = V.shape
    Q = torch.from_numpy(np.random.default_rng(4321).normal(
        size=(N_MIPS_QUERIES, N)).astype(np.float32)).cuda()
    # exact search through the exhaustive baseline's entry point (the
    # padded table divides into its (256, 512) tiles; padding masked)
    kops.reset_launch_counts()
    exact_ids = [torch.topk(kops.blocked_matvec(table, q)[:n_valid],
                            K).indices.tolist() for q in Q]
    matvec_launches = kops.launch_counts()["blocked_matvec"]
    check(matvec_launches == len(Q)
          and kops.launch_counts()["blocked_matvec[bulk]"] == len(Q),
          f"mips: {matvec_launches} blocked_matvec launches "
          f"({kops.launch_counts()['blocked_matvec[bulk]']} bulk) for "
          f"{len(Q)}")
    qerr = {mode: measured_plan_quant_err(V, precision="pq", block=(
        512 if mode == "row" else 128), device=DEV)
        for mode in ("row", "coord")}
    say(f"mips: pq quant_err measured once per mode on the table (not per "
        f"call): {json.dumps(qerr)}")
    out, fp32_row = {}, None
    for label, precision, adaptive, bound in TIERS:
        for mode in ("row", "coord"):
            res, outs = mips_run(
                V, Q, label, precision, adaptive, bound, mode,
                qerr[mode] if precision == "pq" else None, exact_ids)
            out[(label, mode)] = res
            if (label, mode) == ("fp32", "row"):
                fp32_row = outs
            torch.cuda.empty_cache()

    # the served fp32 scores again, through the pull step's entry point:
    # each candidate's tile summed over every column block
    plan = make_plan(n, N, K=K)
    V4 = tile_table(V, plan, DEV)
    qp = torch.nn.functional.pad(Q, (0, plan.n_blocks * plan.block - N))
    cols = torch.arange(plan.n_blocks, device=DEV)
    kops.reset_launch_counts()
    for b, (ids, scores) in enumerate(fp32_row):
        rows = kops.gather_block_dot(V4, ids.long() // plan.tile, cols,
                                     qp[b].reshape(plan.n_blocks, -1))
        again = rows[torch.arange(K, device=DEV),
                     ids.long() % plan.tile] / N
        check(torch.allclose(again, scores, rtol=EXACT_RTOL, atol=0.0),
              f"mips: gather_block_dot rescore {again.tolist()} vs served "
              f"{scores.tolist()}")
    gather_launches = kops.launch_counts()["gather_block_dot"]
    check(gather_launches == len(Q)
          and kops.launch_counts()["gather_block_dot[bulk]"] == len(Q),
          f"mips: {gather_launches} gather_block_dot launches "
          f"({kops.launch_counts()['gather_block_dot[bulk]']} bulk) for "
          f"{len(Q)}")
    del V4

    # nearest neighbours: queries near known rows
    rng = np.random.default_rng(77)
    rows = rng.choice(n, 2, replace=False).tolist()
    V64 = V.double()
    sq = (V64 * V64).sum(1)
    kops.reset_launch_counts()
    for r in rows:
        q = V[r] + 0.002 * torch.from_numpy(rng.normal(size=N).astype(
            np.float32)).cuda()
        ids, scores = mips.nns_topk(V, q, K, eps=EPS, delta=DELTA,
                                    final_exact=True, device=DEV)
        d2 = sq - 2.0 * (V64 @ q.double())
        nn = torch.topk(-d2, K).indices.tolist()
        ids_l = ids.tolist()
        check(len(set(ids_l)) == K and ids_l[0] == nn[0] == r,
              f"nns: query near row {r}: ids {ids_l}, exact {nn}")
        aug = (2.0 * (V64[ids.long()] @ q.double()) - sq[ids.long()]) / (
            N + 1)
        check(torch.allclose(scores.double(), aug, rtol=EXACT_RTOL,
                             atol=0.0),
              f"nns: scores {scores.tolist()} vs exact {aug.tolist()}")
        say(f"nns near row {r}: ids {ids_l}, exact {nn}, overlap "
            f"{len(set(ids_l) & set(nn))}/{K}")
    check(kops.launch_counts()["fused_cascade[fp32]"] == len(rows),
          "nns: one fused_cascade launch per call")
    del V64, sq

    # per-query keys: one batched launch equals the single-query calls
    Qb = Q[:4]
    plan = make_plan(n, N, K=K, eps=EPS, delta=DELTA,
                     value_range=mips.default_value_range(V, Qb))
    perms = draw_perms(plan.n_blocks, 4, torch.Generator().manual_seed(3))
    kops.reset_launch_counts()
    ids, vals = bounded_me_batched(V, Qb, perms, plan=plan, final_exact=True,
                                   device=DEV)
    torch.cuda.synchronize()
    counts = kops.launch_counts()
    check(counts["fused_cascade_batched[fp32]"] == 1
          and counts["fused_cascade"] == 0,
          f"batched: {counts['fused_cascade_batched']} batched and "
          f"{counts['fused_cascade']} single launches, expected 1 and 0")
    for b in range(4):
        sids, svals, _ = bounded_me_blocked(V, Qb[b], perms[b], plan=plan,
                                            final_exact=True, device=DEV)
        check(torch.equal(sids, ids[b]) and torch.equal(svals, vals[b]),
              f"batched: query {b} ids {ids[b].tolist()} / {sids.tolist()} "
              f"not bitwise the single-query call's")
    say("batched: 4 queries, per-query perms, 1 fused_cascade_batched "
        "launch, bitwise equal to 4 single-query calls")
    out["matvec_launches"] = matvec_launches
    out["gather_launches"] = gather_launches
    return out


@contextlib.contextmanager
def recording_heads():
    """Record every call of a decode head: ``(head, hidden states, perm,
    (ids, scores))``, for holding each step's launch afterwards."""
    from repro_torch.models import steps
    calls, real = [], steps.MipsHead.__call__

    def recording(self, hid, perm):
        out = real(self, hid, perm)
        calls.append((self, hid.clone(), perm, out))
        return out
    steps.MipsHead.__call__ = recording
    try:
        yield calls
    finally:
        steps.MipsHead.__call__ = real


def hold_head_steps(what: str, calls, cfg, table) -> dict:
    """Each recorded decode step's hidden states outside any autograd
    graph; its head launch against the plain version on the same hidden
    states, table and perm (ids equal or a near-tie, scores to rtol
    1e-5); its served score the float64 exact product of the served row
    (rtol 1e-4); and the gap of the served row to the exact best row, in
    mean-product units (the eps scale)."""
    from repro_torch.models.model import masked_logits
    errs, ties, gap = [], 0, 0.0
    N = cfg.d_model
    table = table.detach()             # a trained table requires grad
    for step, (head, hid, perm, out) in enumerate(calls):
        check(not hid.requires_grad and head.V4.grad_fn is None
              and out[1].grad_fn is None,
              f"decode {what} step {step}: serving built an autograd graph")
        with plain_route():
            ref = head(hid, perm)
        torch.cuda.synchronize()
        r = compare(table, hid.float(), out, ref,
                    what=f"decode {what} step {step}")
        errs.append(r["max_abs_err"])
        ties += r["near_tie_queries"]
        ids = out[0][:, 0].long()
        check(bool((ids < cfg.vocab).all()),
              f"decode {what} step {step}: a padding row {ids.tolist()}")
        exact = (table[ids].double() * hid.double()).sum(-1) / N
        check(torch.allclose(out[1][:, 0].double(), exact, rtol=EXACT_RTOL,
                             atol=0.0),
              f"decode {what} step {step}: scores {out[1][:, 0].tolist()} "
              f"vs exact {exact.tolist()}")
        best = masked_logits(cfg, table, hid).max(-1).values
        gap = max(gap, float((best.double() / N - exact).max()))
    return {"steps": len(calls), "max_abs_err": max(errs),
            "near_tie_queries": ties, "max_gap_mean_product": gap}


def decode_args(arch: str, mips: str, tokens: int = 32, prompt: int = 16):
    from repro_torch.launch import serve
    return serve.parse_args(["--arch", arch, "--mips", mips, "--eps",
                             str(EPS), "--delta", str(DELTA), "--batch",
                             str(B), "--prompt-len", str(prompt),
                             "--tokens", str(tokens), "--device", DEV])


def phase_decode() -> dict:
    """Phase 10: the decode demo (``serve`` without ``--loop``) on the
    card: qwen1.5-0.5b at full width and depth in bf16 with the bandit
    head and with the exact head, tinyllama-1.1b at full width and 2
    layers, and the model on the card against the model on the CPU."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.fused_cascade import fused_cascade_batched_cuda
    from repro_torch.launch import serve
    from repro_torch.models.model import DenseLM, masked_logits
    from repro_torch.models.steps import prefill_step

    out = {}
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    args = decode_args("qwen1.5-0.5b", "boundedme")
    warm = serve.run_decode_demo(decode_args("qwen1.5-0.5b", "boundedme", 2))
    model = warm["model"]
    kops.reset_launch_counts()
    with recording_heads() as calls:
        res = serve.run_decode_demo(args, model=model)
    counts = kops.launch_counts()
    launches = counts["fused_cascade_batched[bf16]"]
    check(launches == args.tokens == counts["fused_cascade_batched"]
          == len(calls),
          f"decode: {launches} fused_cascade_batched[bf16] launches "
          f"({counts['fused_cascade_batched']} in all, {len(calls)} head "
          f"calls) for {args.tokens} decode steps")
    cfg, table = res["cfg"], model.head_table
    check(table.dtype == torch.bfloat16 and calls[0][0].V4.dtype
          == torch.bfloat16, "decode: the head is not on the bf16 table")
    held = hold_head_steps("qwen1.5-0.5b", calls, cfg, table)
    exact = serve.run_decode_demo(decode_args("qwen1.5-0.5b", "exact"),
                                  model=model)
    agree = float((res["tokens"] == exact["tokens"]).mean())
    # the head's launch alone, on step 0's operands, bitwise the fp32
    # launch on its tiled table widened to f32, and against that launch
    # in turns, the order swapped each pair
    head = calls[0][0]
    out["head"] = head_launch(calls, cfg, table, widened=True)
    ops, kw = head_operands(calls, cfg)
    wide_ops = (ops[0].float(), *ops[1:])
    pairs = []
    for i in range(6):
        t = {}
        for tag, o in (("bf16", ops), ("fp32", wide_ops))[::1 - 2 * (i % 2)]:
            t[tag] = time_cuda(lambda: fused_cascade_batched_cuda(*o, **kw),
                               10, 2)
        pairs.append(t)
    out["head"].update(
        launches=launches, S=ops[2].numel(),
        **pull_split(fused_cascade_batched_cuda, ops,
                     out["head"]["kernel_ms"], **kw),
        max_abs_err=held["max_abs_err"],
        bf16_ms_pairs=[p["bf16"] for p in pairs],
        fp32_widened_ms_pairs=[p["fp32"] for p in pairs],
        pairs_bf16_faster=sum(p["bf16"] < p["fp32"] for p in pairs))
    say("decode head: " + json.dumps(out["head"]))
    out["qwen1.5-0.5b"] = {
        **held, "launches": launches, "token_agreement_with_exact": agree,
        "eps": EPS,
        "prefill_ms": res["prefill_ms"], "ms_per_token": res["ms_per_token"],
        "exact_prefill_ms": exact["prefill_ms"],
        "exact_ms_per_token": exact["ms_per_token"],
        "weights_gb": sum(p.numel() * p.element_size()
                          for p in model.parameters()) / 1e9,
        "head_table_gb": head.V4.numel() * head.V4.element_size() / 1e9,
        "mem_before_gb": base_gb,
        "peak_added_gb": torch.cuda.max_memory_allocated() / 1e9 - base_gb}
    say("decode qwen1.5-0.5b: " + json.dumps(out["qwen1.5-0.5b"]))
    del model, warm, res, exact, calls, head, ops, wide_ops
    torch.cuda.empty_cache()

    # tinyllama-1.1b at full width (GQA 32/4, untied 32,000-row
    # unembedding padded to 32,768), depth cut to 2 layers
    args = decode_args("tinyllama-1.1b", "boundedme")
    cfg = dataclasses.replace(serve.decode_config(args), n_layers=2)
    kops.reset_launch_counts()
    with recording_heads() as calls:
        res = serve.run_decode_demo(args, cfg=cfg)
    launches = kops.launch_counts()["fused_cascade_batched[bf16]"]
    check(launches == args.tokens == len(calls),
          f"decode tinyllama: {launches} launches for {args.tokens} steps")
    table = res["model"].head_table
    check(table is res["model"].unembed, "decode tinyllama: the head is "
          "not the unembedding")
    out["tinyllama-1.1b"] = {
        **hold_head_steps("tinyllama-1.1b", calls, cfg, table),
        "launches": launches, "layers": cfg.n_layers,
        "prefill_ms": res["prefill_ms"], "ms_per_token": res["ms_per_token"]}
    say("decode tinyllama-1.1b: " + json.dumps(out["tinyllama-1.1b"]))
    del res, calls, table
    torch.cuda.empty_cache()

    # the model on the card against the model on the CPU: qwen1.5-0.5b at
    # 2 layers in fp32 (TF32 off), prefill and the first decode step
    cfg = dataclasses.replace(serve.decode_config(decode_args(
        "qwen1.5-0.5b", "exact")), n_layers=2, dtype="float32")
    card = DenseLM(cfg, seed=0, device=DEV)
    host = copy.deepcopy(card).to("cpu")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (B, 16))
    hidden, nxt = {}, {}
    for name, m in (("card", card), ("cpu", host)):
        tok = torch.from_numpy(prompt).to(m.embed.device)
        _, caches = prefill_step(m, tok, cache_len=17)
        h, _ = m(tok[:, -1:], caches=caches, pos=16)
        hidden[name] = h[:, -1].cpu()
        nxt[name] = torch.argmax(masked_logits(cfg, m.head_table, h[:, -1]),
                                 -1).cpu()
    err = float((hidden["card"] - hidden["cpu"]).abs().max())
    scale = float(hidden["cpu"].abs().max())
    check(torch.equal(nxt["card"], nxt["cpu"]),
          f"decode card vs cpu: next tokens {nxt['card'].tolist()} vs "
          f"{nxt['cpu'].tolist()}")
    check(torch.allclose(hidden["card"], hidden["cpu"], rtol=CARD_CPU_RTOL,
                         atol=CARD_CPU_RTOL * scale),
          f"decode card vs cpu: hidden states differ by {err:.3g} "
          f"(max |h| {scale:.3g})")
    out["card_vs_cpu"] = {"layers": 2, "dtype": "float32",
                          "next_tokens_equal": True,
                          "hidden_max_abs_err": err, "hidden_max": scale,
                          "rtol": CARD_CPU_RTOL}
    say("decode card vs cpu: " + json.dumps(out["card_vs_cpu"]))
    return out


def head_operands(calls, cfg):
    """The fused cascade's operands and keywords of the first recorded
    decode step's head launch (the hidden states zero-padded to the
    plan's blocks, as `decode_tiled` pads them)."""
    head, hid, perm, _ = calls[0]
    plan = head.plan
    Q = torch.nn.functional.pad(hid.float(),
                                (0, plan.n_blocks * plan.block - plan.N))
    ops, kw = cascade_operands(plan, head.V4, Q, perm)
    kw["n_valid"] = cfg.vocab
    return ops, kw


def head_launch(calls, cfg, table, *, widened: bool) -> dict:
    """The head's launch alone on step 0's operands: its ms (CUDA events)
    against its bound, the plain version and ``torch.matmul`` +
    ``torch.topk`` on the same bf16 table; with ``widened``, also bitwise
    the fp32 launch on the tiled table widened to f32."""
    from repro_torch.core.schedule import PULL_BIT
    from repro_torch.kernels.fused_cascade import fused_cascade_batched_cuda
    from repro_torch.kernels.ref import fused_cascade_batched_ref
    head, hid, _, _ = calls[0]
    plan = head.plan
    ops, kw = head_operands(calls, cfg)
    if widened:
        got = fused_cascade_batched_cuda(*ops, **kw)
        wide = fused_cascade_batched_cuda(ops[0].float(), *ops[1:], **kw)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, wide)),
              f"{cfg.name}: the bf16 launch is not bitwise the fp32 launch "
              f"on the widened table")
        del got, wide
    pulled = torch.zeros((plan.n_tiles, plan.n_blocks), dtype=torch.bool,
                         device=DEV)
    fused_cascade_batched_ref(*ops, pulled=pulled, **kw)
    n_pulls = int(((ops[2].cpu() & PULL_BIT) != 0).sum()) * hid.shape[0]
    bound = kernel_bound(plan, ops, kw, pulled, n_pulls)
    pad = torch.arange(table.shape[0], device=DEV) >= cfg.vocab

    def library():
        s = (hid @ table.T).masked_fill_(pad, -torch.inf)
        return torch.topk(s, 1, dim=1)
    return {
        **bound, "table": list(table.shape), "n_blocks": plan.n_blocks,
        "ragged_block": plan.N % plan.block or None,
        "rounds": len(plan.schedule.rounds), "speedup": plan.schedule.speedup,
        "kernel_ms": time_cuda(lambda: fused_cascade_batched_cuda(*ops, **kw),
                               10, 2),
        "plain_ms": time_cuda(lambda: fused_cascade_batched_ref(*ops, **kw),
                              3, 1),
        "library_ms": time_cuda(library, 10, 2),
        "bitwise_fp32_widened": widened or None}


def family_run(arch: str, layers, prompt: int, tokens: int, cut) -> dict:
    """One arch of phase 13: the bandit and the exact decode demo on one
    model at full width (depth ``layers``), every head launch held."""
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import serve
    args = decode_args(arch, "boundedme", tokens, prompt)
    cfg = serve.decode_config(args)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    warm = serve.run_decode_demo(decode_args(arch, "boundedme", 2, prompt),
                                 cfg=cfg)
    model, warm_s = warm["model"], time.perf_counter() - t0
    del warm
    kops.reset_launch_counts()
    with recording_heads() as calls:
        res = serve.run_decode_demo(args, cfg=cfg, model=model)
    counts = kops.launch_counts()
    launches = counts["fused_cascade_batched[bf16]"]
    check(launches == tokens == counts["fused_cascade_batched"]
          == len(calls),
          f"{arch}: {launches} fused_cascade_batched[bf16] launches "
          f"({counts['fused_cascade_batched']} in all, {len(calls)} head "
          f"calls) for {tokens} decode steps")
    table = model.head_table
    check(table.dtype == torch.bfloat16 and calls[0][0].V4.dtype
          == torch.bfloat16, f"{arch}: the head is not on the bf16 table")
    held = hold_head_steps(arch, calls, cfg, table)
    exact = serve.run_decode_demo(
        decode_args(arch, "exact", tokens, prompt),
        cfg=dataclasses.replace(cfg, mips_mode="exact"), model=model)
    head = head_launch(calls, cfg, table,
                       widened=arch == "qwen3-moe-30b-a3b")
    out = {
        **held, "launches": launches, "layers": cfg.n_layers,
        "cut": cut, "prompt_len": prompt, "tokens": tokens,
        "token_agreement_with_exact": float(
            (res["tokens"] == exact["tokens"]).mean()),
        "prefill_ms": res["prefill_ms"], "ms_per_token": res["ms_per_token"],
        "exact_prefill_ms": exact["prefill_ms"],
        "exact_ms_per_token": exact["ms_per_token"],
        "build_and_warm_s": warm_s,
        "weights_gb": sum(p.numel() * p.element_size()
                          for p in model.parameters()) / 1e9,
        "head_table_gb": calls[0][0].V4.numel()
        * calls[0][0].V4.element_size() / 1e9,
        "mem_before_gb": base_gb,
        "peak_added_gb": torch.cuda.max_memory_allocated() / 1e9 - base_gb,
        "head": head}
    say(f"families {arch}: " + json.dumps(out))
    del model, res, exact, calls, table
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_families() -> dict:
    """Phase 13: every other family's decode demo at full width on the
    card (`FAMILY_RUNS`), then qwen3-moe at 2 layers in fp32 on the card
    against the CPU."""
    from repro_torch.launch import serve
    from repro_torch.models.model import build_model, masked_logits
    from repro_torch.models.steps import prefill_step
    t_phase = time.perf_counter()
    out = {arch: family_run(arch, layers, prompt, tokens, cut)
           for arch, layers, prompt, tokens, cut in FAMILY_RUNS}

    # the model on the card against the model on the CPU: qwen3-moe at
    # full width, 2 layers, fp32 (TF32 off), prefill and a decode step;
    # the CPU copy is taken tensor by tensor (no second card copy)
    cfg = dataclasses.replace(serve.decode_config(decode_args(
        "qwen3-moe-30b-a3b", "exact", 1)), n_layers=2, dtype="float32")
    card = build_model(cfg, seed=0, device=DEV)
    host = build_model(cfg, device="meta")
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()},
                         assign=True)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (B, 16))
    hidden, nxt = {}, {}
    for name, m in (("card", card), ("cpu", host)):
        tok = torch.from_numpy(prompt).to(m.embed.device)
        _, caches = prefill_step(m, tok, cache_len=17)
        h, _ = m(tok[:, -1:], caches=caches, pos=16)
        hidden[name] = h[:, -1].cpu()
        nxt[name] = torch.argmax(masked_logits(cfg, m.head_table, h[:, -1]),
                                 -1).cpu()
    err = float((hidden["card"] - hidden["cpu"]).abs().max())
    scale = float(hidden["cpu"].abs().max())
    check(torch.equal(nxt["card"], nxt["cpu"]),
          f"families card vs cpu: next tokens {nxt['card'].tolist()} vs "
          f"{nxt['cpu'].tolist()}")
    check(torch.allclose(hidden["card"], hidden["cpu"], rtol=CARD_CPU_RTOL,
                         atol=CARD_CPU_RTOL * scale),
          f"families card vs cpu: hidden states differ by {err:.3g} "
          f"(max |h| {scale:.3g})")
    out["card_vs_cpu"] = {"arch": cfg.name, "layers": 2, "dtype": "float32",
                          "next_tokens_equal": True,
                          "hidden_max_abs_err": err, "hidden_max": scale,
                          "rtol": CARD_CPU_RTOL}
    say("families card vs cpu: " + json.dumps(out["card_vs_cpu"]))
    del card, host
    gc.collect()
    torch.cuda.empty_cache()
    say(f"families: phase in {time.perf_counter() - t_phase:.1f} s")
    return out


def load_example(name: str):
    """The port's example ``examples_torch/<name>.py`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: what ``examples/quickstart.py`` prints on the CPU (jax 0.9.0): the
#: exact top-5 and, per eps multiple, the plan's FLOP speedup
QUICKSTART_JAX = {"exact": [13655, 3098, 19016, 10172, 18189],
                  "speedup": {0.5: "1.0", 2.0: "1.3", 8.0: "4.4"}}


def hold_ids(V, q, got, want, what: str) -> int:
    """Top-K ids ``got`` against ``want``: equal, or every differing
    position's float64 exact score within 1e-5 relative of the one it
    replaced (a near-tie); returns the near-tie count."""
    ties = 0
    for j, (a, c) in enumerate(zip(got, want, strict=True)):
        if a == c:
            continue
        sa = float(V[a].double() @ q.double())
        sc = float(V[c].double() @ q.double())
        check(abs(sa - sc) <= 1e-5 * abs(sc),
              f"{what}: position {j}: id {a} (exact {sa:.9g}) vs {c} "
              f"(exact {sc:.9g})")
        ties += 1
    return ties


def phase_quickstart() -> dict:
    """Phase 9, and phase 17 (a): ``examples_torch/quickstart.py``'s `run`
    on the card, the launch counts set to 0 just before and read just
    after: one ``fused_cascade[fp32]`` launch per eps multiple, each held
    against the plain version on the same permutation, the served scores
    exact, the exact top-5 against a float64 search and the JAX example's
    printed list; then the kernel alone on each call's operands."""
    from repro_torch.core.boundedme_torch import (draw_perms, make_plan,
                                                  tile_table)
    from repro_torch.core.schedule import PULL_BIT
    from repro_torch.data.synthetic import mf_dataset
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.fused_cascade import fused_cascade_cuda
    from repro_torch.kernels.ref import fused_cascade_ref
    qs = load_example("quickstart")

    n, N = MF_SHAPE
    t0 = time.perf_counter()
    Vn, qn = mf_dataset(n, N, rank=32, seed=0)
    sigma, vr = qs.knobs(Vn, qn)
    say(f"quickstart: mf_dataset{(n, N)} in {time.perf_counter() - t0:.1f}"
        f" s, sigma {sigma:.6g}, value_range {vr:.6g}")
    kops.reset_launch_counts()
    res = qs.run(Vn, qn, device=DEV, log=lambda s: say("quickstart: " + s))
    torch.cuda.synchronize()
    launches = kops.launch_counts()["fused_cascade[fp32]"]
    check(launches == len(qs.MULTS) == len(res["runs"]),
          f"quickstart: {launches} fused_cascade[fp32] launches for "
          f"{len(qs.MULTS)} searches")
    V, q = torch.from_numpy(Vn).to(DEV), torch.from_numpy(qn).to(DEV)
    del Vn
    exact = torch.topk(V.double() @ q.double(), 5).indices.tolist()
    got = res["exact"].tolist()
    ties = hold_ids(V, q, got, exact, "quickstart exact vs float64")
    ties += hold_ids(V, q, got, QUICKSTART_JAX["exact"],
                     "quickstart exact vs the JAX example")
    library_ms = time_cuda(lambda: torch.topk(V @ q, 5), 10, 2)
    out = {"launches": launches, "exact": got,
           "exact_equals_jax": got == QUICKSTART_JAX["exact"],
           "exact_near_ties": ties}
    errs = []
    for run in res["runs"]:
        mult, eps, ids, scores = (run[k] for k in ("mult", "eps", "ids",
                                                   "scores"))
        check(f"{run['speedup']:4.1f}".strip()
              == QUICKSTART_JAX["speedup"][mult],
              f"quickstart {mult}: speedup {run['speedup']} vs the JAX "
              f"example's {QUICKSTART_JAX['speedup'][mult]}")
        with plain_route():
            pids, pscores = qs.search(V, q, eps, vr, device=DEV)
        r = compare(V, q[None], [ids[None], scores[None]],
                    [pids[None], pscores[None]],
                    what=f"quickstart eps={mult}*sigma")
        errs.append(r["max_abs_err"])
        ex = (V[ids.long()].double() @ q.double()) / N
        check(torch.allclose(scores.double(), ex, rtol=EXACT_RTOL, atol=0.0),
              f"quickstart {mult}: scores {scores.tolist()} vs exact "
              f"{ex.tolist()}")
        # the kernel alone, on the operands the call built (its perm: the
        # generator seeded 0)
        plan = make_plan(n, N, K=5, eps=eps, delta=0.1, value_range=vr,
                         block=128)
        V4 = tile_table(V, plan, DEV)
        ops_, kw_ = cascade_operands(plan, V4, torch.nn.functional.pad(
            q, (0, plan.n_blocks * plan.block - N))[None],
            draw_perms(plan.n_blocks))
        sops, skw = single_of(ops_, kw_)
        pulled = torch.zeros((plan.n_tiles, plan.n_blocks), dtype=torch.bool,
                             device=DEV)
        fused_cascade_ref(*sops, pulled=pulled, **skw)
        n_pulls = int(((sops[2].cpu() & PULL_BIT) != 0).sum())
        kernel_ms = time_cuda(lambda: fused_cascade_cuda(*sops, **skw), 10,
                              2)
        calls = []
        for _ in range(5):
            t0 = time.perf_counter()
            qs.search(V, q, eps, vr, device=DEV)
            torch.cuda.synchronize()
            calls.append(1e3 * (time.perf_counter() - t0))
        rec = {"eps_sigma": mult, "overlap": run["overlap"],
               "overlap_float64": len(set(ids.tolist()) & set(exact)),
               "speedup": run["speedup"],
               "rounds": len(plan.schedule.rounds),
               **kernel_bound(plan, sops, skw, pulled, n_pulls),
               "kernel_ms": kernel_ms,
               "plain_ms": time_cuda(lambda: fused_cascade_ref(*sops, **skw),
                                     3, 1),
               "call_ms": statistics.median(calls),
               "example_wall_s": run["wall_s"], "library_ms": library_ms,
               "max_abs_err": r["max_abs_err"],
               "near_tie_queries": r["near_tie_queries"]}
        out[mult] = rec
        say("quickstart: " + json.dumps(rec))
        del V4, ops_, sops
    out["max_abs_err"] = max(errs)
    return out


#: phase 11: the vocab table in S row shards on the one card (a mesh that
#: repeats it), through the CLI's own code: (label, precision, adaptive,
#: bound, shards) of every ``--loop --shards`` run
SHARD_TIERS = [(*t, 4) for t in TIERS] + [(*TIERS[0], 3), (*TIERS[1], 3)]
SHARD_ARGV = ["--arch", "qwen1.5-0.5b", "--loop", "--requests", "64",
              "--batch", "4", "--topk", str(K), "--eps", str(EPS),
              "--delta", str(DELTA), "--pull-mode", "row"]
#: the sharded tenant beside two paging ones: (name, rows, tier); the
#: budget holds ``vocab`` and one of the others, plus 5 %
SHARD_TENANTS = [("vocab", 151_936, "fp32"), ("pages_a", 131_072, "int8"),
                 ("pages_b", 131_072, "fp32")]
SHARD_TENANT_ARRIVALS = 96
SHARD_TENANT_DEADLINE_MS = 20.0


def card_mesh(S: int):
    """S shards on the one card: the mesh repeats it."""
    from repro_torch.distributed.sharding import Mesh
    return Mesh([DEV] * S)


class ShardRows:
    """Global row ``i`` of a sharded executor's tables as they stand (a
    store's tiled shards, or a static table's), indexed as `compare`
    indexes a table."""

    def __init__(self, ex):
        self.ex = ex

    def __getitem__(self, i):
        shards = self.ex.shard_operands()[0]
        n_local, R = self.ex.plan.n, self.ex.plan.tile
        s, j = divmod(int(i), n_local)
        return shards[s][j // R, :, j % R, :].reshape(-1)[:self.ex.N]


def hold_sharded(ex, Qbuf, perm, out, what: str) -> dict:
    """Hold one sharded dispatch against the per-shard plain versions on
    the same shard tables, artifacts, perm and live counts, merged by the
    same rule: ids equal (or a near-tie), int8 / int4 scores and
    ``rounds_used (B, S)`` bitwise, fp32 and pq to ``SCORE_RTOL``."""
    from repro_torch.distributed.sharding import sharded_decode_tiled
    shards, quant, nv = ex.shard_operands()
    Q = torch.from_numpy(Qbuf).to(DEV)
    with plain_route():
        ref = sharded_decode_tiled(
            shards, Q, perm, mesh=ex.mesh, plan=ex.plan, K=ex.K,
            k_out=ex._k_out, n_valid=nv, quantized=quant,
            adaptive=ex.adaptive)
    ref = (ref[0], ref[1], ref[3]) if ex.adaptive else ref[:2]
    got = [torch.from_numpy(t) for t in out[:3 if ex.adaptive else 2]]
    return compare(ShardRows(ex), Q, got, ref, what=what,
                   bitwise=ex.plan.precision in ("int8", "int4"))


def shard_split(ex, Qbuf, perm) -> dict:
    """The S launches of one sharded dispatch, back to back on the card's
    stream: their ms (CUDA events, median of 10 after 2 warm-ups), and
    again with every PULL_BIT cleared (the same round ends, no pulls)."""
    from repro_torch.core.schedule import PULL_BIT
    from repro_torch.kernels.fused_cascade import fused_cascade_batched_cuda
    shards, quant, nv = ex.shard_operands()
    Q = torch.from_numpy(Qbuf).to(DEV)
    ops = []
    for s, V4 in enumerate(shards):
        o, kw = cascade_operands(ex.plan, V4, Q, perm, adaptive=ex.adaptive,
                                 quantized=None if quant is None
                                 else quant[s])
        kw.update(k_out=ex._k_out, n_valid=int(nv[s]))
        ops.append((o, kw))
    idle = [((o[0], o[1], o[2] & ~PULL_BIT, o[3], o[4]), kw)
            for o, kw in ops]
    ms = time_cuda(lambda: [fused_cascade_batched_cuda(*o, **kw)
                            for o, kw in ops], 10, 2)
    ends = time_cuda(lambda: [fused_cascade_batched_cuda(*o, **kw)
                              for o, kw in idle], 10, 2)
    return {"kernel_ms": ms, "round_end_ms": ends, "pull_ms": ms - ends}


def sharded_serve_run(label, precision, adaptive, bound, S, served,
                      kern) -> dict:
    """Phase 11a: ``--loop --shards S`` through `MIPSServeEngine`."""
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import serve

    args = serve.parse_args(SHARD_ARGV + [
        "--shards", str(S), "--precision", precision, "--bound", bound]
        + (["--adaptive"] if adaptive else []))
    mesh = card_mesh(S)
    gc.collect()                # the last run's engine lets go of its table
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    engine, qs = serve.build_loop(args, mesh)
    ex = engine.executor
    held_gb = torch.cuda.memory_allocated() / 1e9 - base_gb
    check(ex.mesh is mesh and ex.plan.n == -(-ex.n // S),
          f"sharded {label} S={S}: plan of {ex.plan.n} rows for {ex.n}")
    tag = tier_tag(label, ex._table)
    name = f"fused_cascade_batched[{tag}]"
    held, dts = [], []
    real = ex.dispatch

    def holding(Qbuf, perm):
        out = real(Qbuf, perm)
        dts.append(out[3])
        held.append(hold_sharded(ex, Qbuf, perm, out,
                                 f"sharded {label} S={S} dispatch "
                                 f"{len(held)}"))
        return out
    ex.dispatch = holding
    kops.reset_launch_counts()
    stats = serve.simulate_stream(engine, qs,
                                  interarrival_ms=args.interarrival_ms,
                                  pattern=args.pattern,
                                  seed=args.stream_seed)
    counts = kops.launch_counts()
    check(ex.n_dispatches > 0 and counts[name] == S * ex.n_dispatches
          == counts["fused_cascade_batched"],
          f"sharded {label} S={S}: {counts[name]} {name} launches "
          f"({counts['fused_cascade_batched']} in all) for "
          f"{ex.n_dispatches} dispatches of {S} shards")
    check(stats["completed"] == args.requests,
          f"sharded {label} S={S}: {stats['completed']} completed")
    table, n_valid = ex._table, ex.n_valid
    recalls = []
    exact = torch.topk(table[:n_valid].float()
                       @ torch.from_numpy(qs).to(DEV).T, K, dim=0).indices
    for rid in range(args.requests):
        res = engine.result(rid)
        check(res is not None, f"sharded {label}: request {rid} unanswered")
        check_served(table, qs[rid], *res, n_valid,
                     f"sharded {label} S={S}: request {rid}")
        recalls.append(len(set(res[0].tolist())
                           & set(exact[:, rid].tolist())) / K)
    res = {"shards": S, "launches": counts[name],
           "dispatches": ex.n_dispatches,
           "max_abs_err": max(h["max_abs_err"] for h in held),
           "near_tie_queries": sum(h["near_tie_queries"] for h in held),
           "dispatch_ms_median": 1e3 * statistics.median(dts),
           "unsharded_dispatch_ms_median":
               served[tag]["dispatch_ms_median"],
           "recall_at_k": float(np.mean(recalls)),
           "p50_ms": stats["latency_ms"]["p50"],
           "p95_ms": stats["latency_ms"]["p95"],
           "held_gb": held_gb,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9 - base_gb}
    if adaptive:
        res["adaptive"] = stats["adaptive"]
    if label == "fp32":         # (a cleared schedule never exits early)
        Qbuf = np.ascontiguousarray(qs[:B])
        res["split"] = shard_split(ex, Qbuf, torch.randperm(
            ex.plan.n_blocks, generator=torch.Generator().manual_seed(0)))
        res["unsharded_kernel_ms"] = kern[(tag, "row")]["kernel_ms"]
    ex.dispatch = real
    say(f"sharded {label} S={S}: " + json.dumps(res))
    return res


def sharded_runtime_run(label, precision, adaptive, bound, S,
                        dynamic: bool) -> dict:
    """Phase 11b-c: ``--loop --runtime --shards S`` with the runtime
    phase's settings, and with ``--dynamic`` under churn and flush
    faults; every dispatch held before the next flush; the store after
    the stream bytewise a fresh store over the same live ids."""
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import serve
    from repro_torch.store import ShardedTableStore

    tmp = tempfile.TemporaryDirectory()
    art = {k: str(Path(tmp.name) / f"{k}.{ext}") for k, ext in
           (("metrics", "prom"), ("trace", "json"), ("flight", "json"))}
    argv = (STORE_ARGV if dynamic else RUNTIME_ARGV) + [
        "--shards", str(S), "--precision", precision, "--bound", bound,
        "--metrics-out", art["metrics"], "--trace-out", art["trace"],
        "--flight-recorder-path", art["flight"]] + (
            ["--adaptive"] if adaptive else [])
    args = serve.parse_args(argv)
    what = f"sharded {'store ' if dynamic else ''}runtime {label} S={S}"
    mesh = card_mesh(S)
    gc.collect()                # the last run's engine lets go of its table
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    engine, qs = serve.build_loop(args, mesh)
    execs, store = engine.executors, engine.store
    held_gb = torch.cuda.memory_allocated() / 1e9 - base_gb
    check(all(ex.mesh is mesh for ex in execs)
          and (store is not None) == dynamic,
          f"{what}: rungs {[ex.mesh for ex in execs]}, store {store}")
    if dynamic:
        check(isinstance(store, ShardedTableStore)
              and all(ex.shard_operands()[0][s] is store.tiled_shards()[s]
                      for ex in execs for s in range(S)),
              f"{what}: rungs do not read the store's shards")
    qs = list(qs)
    N = engine.N
    for i, bad in zip((5, 70, 140, 210), (
            np.full(N, np.nan, np.float32), np.full(N, np.inf, np.float32),
            np.ones(N + 1, np.float32), np.ones(N - 3, np.float32))):
        qs[i] = bad
    tag = label if dynamic else tier_tag(label, execs[0]._table)
    name = f"fused_cascade_batched[{tag}]"
    kops.reset_launch_counts()
    warm_s = engine.warmup()
    held = []
    for rung, ex in enumerate(execs):
        def holding(Qbuf, perm, rung=rung, ex=ex, real=ex.dispatch):
            out = real(Qbuf, perm)
            r = hold_sharded(ex, Qbuf, perm, out,
                             f"{what} rung {rung} dispatch {len(held)}")
            # served slots distinct live rows, scores exact as they stand
            rows = ShardRows(ex)
            live = (store.live_mask() if dynamic
                    else np.arange(ex.n) < ex.n_valid)
            for i in np.flatnonzero(np.abs(Qbuf).sum(1) > 0):
                slots = out[0][i]
                check(len(set(slots.tolist())) == K and live[slots].all(),
                      f"{what}: lane {i} slots {slots.tolist()}")
                exact = torch.stack([rows[j] for j in slots]).double() @ \
                    torch.from_numpy(Qbuf[i]).to(DEV).double() / N
                check(np.allclose(out[1][i], exact.cpu().numpy(),
                                  rtol=EXACT_RTOL, atol=0),
                      f"{what}: lane {i} scores {out[1][i].tolist()} vs "
                      f"exact {exact.tolist()}")
            held.append((rung, out[3], r))
            return out
        ex.dispatch = holding
    t0 = time.perf_counter()
    stats = serve.serve_stream(args, engine, qs)
    wall = time.perf_counter() - t0
    counts = kops.launch_counts()
    n_disp = sum(ex.n_dispatches for ex in execs)
    check(counts[name] == S * n_disp == counts["fused_cascade_batched"]
          and n_disp == len(execs) + len(held),
          f"{what}: {counts[name]} {name} launches "
          f"({counts['fused_cascade_batched']} in all) for {n_disp} rung "
          f"dispatches of {S} shards, {len(held)} after warm-up")
    try:
        serve.check_outcomes(args, stats)
    except SystemExit as e:
        raise SmokeFailure(f"{what}: {e}") from None
    f = stats["faults"]
    check(f["dispatch_errors"] == f["injected"]["dispatch_errors"],
          f"{what}: {f['dispatch_errors']} dispatch errors, "
          f"{f['injected']['dispatch_errors']} injected")
    res = {"shards": S, "launches": counts[name],
           "dispatches": stats["dispatches"], "held_dispatches": len(held),
           "max_abs_err": max(h[2]["max_abs_err"] for h in held),
           "near_tie_queries": sum(h[2]["near_tie_queries"] for h in held),
           "outcomes": stats["outcomes"],
           "p50_ms": stats["latency_ms"]["p50"],
           "p99_ms": stats["latency_ms"]["p99"],
           "served_per_rung": stats["degradation"]["served_per_rung"],
           "dispatch_ms_median": 1e3 * statistics.median(
               h[1] for h in held),
           "held_gb": held_gb,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9 - base_gb,
           "warmup_s": warm_s, "wall_s": wall}
    if dynamic:
        check(f["store_flush_failures"] == f["injected"]["flush_failures"]
              == store.n_flush_failures > 0 and f["update_errors"] == 0
              and stats["updates"]["applied"] > 0,
              f"{what}: faults {f}, updates {stats['updates']}")
        rows, ids, counts_s = store.snapshot()
        fresh = ShardedTableStore(rows, ids=ids, shard_counts=counts_s,
                                  capacity=store.capacity_rows, mesh=mesh,
                                  block=store.block)
        check(np.array_equal(fresh.host_table(), store.host_table())
              and np.array_equal(fresh._slot_ids, store._slot_ids)
              and all(torch.equal(a, b) for a, b in
                      zip(fresh.tiled_shards(), store.tiled_shards())),
              f"{what}: the store after churn differs from a fresh store "
              f"over the same live ids")
        res.update(per_shard_live=store.n_valid_vector().tolist(),
                   rows_applied=stats["updates"]["applied"],
                   flush_failures=f["store_flush_failures"],
                   bytewise_fresh=True,
                   store_gb=store.device_bytes() / 1e9)
        del fresh
    obs = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "check_obs_artifacts.py"),
         "--metrics", art["metrics"], "--trace", art["trace"],
         "--flight", art["flight"]], capture_output=True, text=True)
    check(obs.returncode == 0, f"{what}: obs artifacts: "
          f"{obs.stdout.strip()} {obs.stderr.strip()}")
    tmp.cleanup()
    say(f"{what}: " + json.dumps(res))
    return res


def sharded_tenancy_run() -> dict:
    """Phase 11d: one sharded tenant (``register(mesh=)``, 4 shards)
    beside two paging tenants, under a budget of the sharded table and
    one other plus 5 %: a short stream pages the two in and out, the
    sharded one stays; evicting it raises; every dispatch held."""
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import serve
    from repro_torch.launch.engine import CascadeExecutor
    from repro_torch.launch.tenancy import (MultiTenantRuntime,
                                            TableRegistry, TenancyError,
                                            TenantConfig)

    mesh = card_mesh(4)
    nbytes = {name: rows * 1024 * 4 * 3 // 2 for name, rows, _ in
              SHARD_TENANTS}
    budget = int(1.05 * (nbytes["vocab"] + max(nbytes["pages_a"] * 5 // 4,
                                               nbytes["pages_b"])))
    reg = TableRegistry(byte_budget=budget, lanes=B, device=DEV)
    held, launches = [], {"sharded": 0, "fp32": 0, "int8": 0}
    real = CascadeExecutor.dispatch

    failures = []

    def holding(ex, Qbuf, perm):
        # each dispatch's launches, read from the counter around it; a
        # failed check is kept, as the runtime's retries would absorb it
        before = kops.launch_counts().get("fused_cascade_batched", 0)
        out = real(ex, Qbuf, perm)
        n = kops.launch_counts().get("fused_cascade_batched", 0) - before
        try:
            if ex.mesh is not None:
                check(n == len(ex.mesh.devices),
                      f"sharded tenancy: {n} launches for a dispatch over "
                      f"{len(ex.mesh.devices)} shards")
                held.append(hold_sharded(ex, Qbuf, perm, out,
                                         f"sharded tenancy dispatch "
                                         f"{len(held)}"))
                launches["sharded"] += n
            else:
                check(n == 1, f"sharded tenancy: {n} launches for an "
                      f"unsharded dispatch")
                launches[ex.plan.precision] += n
        except SmokeFailure as e:
            failures.append(str(e))
            raise
        return out
    CascadeExecutor.dispatch = holding
    try:
        torch.cuda.synchronize()
        base_gb = torch.cuda.memory_allocated() / 1e9
        kops.reset_launch_counts()
        for idx, (name, rows, tier) in enumerate(SHARD_TENANTS):
            cfg = TenantConfig(K=K, eps=EPS, delta=DELTA, precision=tier,
                               block=512,
                               deadline_ms=SHARD_TENANT_DEADLINE_MS,
                               queue_capacity=16, seed=idx)
            reg.register(name, serve.tenant_table(rows, 1024, 0, idx, DEV),
                         cfg, mesh=mesh if name == "vocab" else None)
        check(reg.is_pinned("vocab") and reg.stats()["tenants"]["vocab"][
            "sharded"], "sharded tenancy: vocab is not a pinned shard set")
        try:
            reg.evict("vocab")
            raise SmokeFailure("sharded tenancy: evicting vocab did not "
                               "raise")
        except TenancyError:
            pass
        engine = MultiTenantRuntime(reg, batch_wait_ms=2.0, seed=0)
        engine.warmup()
        # vocab every other arrival; the paging tenants one half each, so
        # each is paged in once the stream turns to it
        names = [t[0] for t in SHARD_TENANTS]
        half = SHARD_TENANT_ARRIVALS // 2
        labels = [names[0] if i % 2 == 0 else names[1 + (i >= half)]
                  for i in range(SHARD_TENANT_ARRIVALS)]
        qs = np.random.default_rng(0).normal(
            size=(SHARD_TENANT_ARRIVALS, 1024)).astype(np.float32)
        trace = serve.arrival_trace(SHARD_TENANT_ARRIVALS,
                                    interarrival_ms=5.0)
        stats = serve.simulate_stream(engine, qs, trace=trace,
                                      open_loop=True,
                                      tenants=lambda i: labels[i])
        counts = kops.launch_counts()
    finally:
        CascadeExecutor.dispatch = real
    check(not failures, f"sharded tenancy: {failures[:3]}")
    r = reg.stats()
    check(counts["fused_cascade_batched[fp32]"]
          == launches["sharded"] + launches["fp32"]
          and counts["fused_cascade_batched[int8]"] == launches["int8"]
          and launches["sharded"] > 0 and r["evictions"] > 0
          and r["page_ins"] > 0 and reg.is_resident("vocab")
          and r["resident_bytes"] <= budget,
          f"sharded tenancy: launches {counts} vs {launches}, registry {r}")
    answered = {n: stats["tenants"][n]["outcomes"]["ok"]
                + stats["tenants"][n]["outcomes"]["degraded"]
                for n in names}
    check(all(v > 0 for v in answered.values()),
          f"sharded tenancy: answered {answered}")
    res = {"launches": launches["sharded"],
           "unsharded_launches": launches["fp32"] + launches["int8"],
           "max_abs_err": max(h["max_abs_err"] for h in held),
           "held_dispatches": len(held), "answered": answered,
           "evictions": r["evictions"], "page_ins": r["page_ins"],
           "budget_gb": budget / 1e9,
           "resident_gb": r["resident_bytes"] / 1e9,
           "sharded_gb": reg.table_bytes("vocab") / 1e9,
           "mem_gb": torch.cuda.memory_allocated() / 1e9 - base_gb}
    say("sharded tenancy: " + json.dumps(res))
    del engine, reg
    gc.collect()
    return res


def sharded_mips_run(table32, n_valid) -> dict:
    """Phase 11e: `sharded_mips_topk` at 4 shards on 8 queries, one
    batched launch per shard with per-query perms, held against the
    plain versions; served scores exact; recall against exact search."""
    from repro_torch.core.mips import sharded_mips_topk
    from repro_torch.kernels import ops as kops

    V = table32[:n_valid]
    rng = np.random.default_rng(11)
    Q = rng.normal(size=(N_MIPS_QUERIES, V.shape[1])).astype(np.float32)
    vr = 2.0 * float(np.abs(Q).max()) * float(V.abs().max())
    g = torch.Generator().manual_seed(3)
    n_blocks = -(-V.shape[1] // 512)
    perms = torch.stack([torch.randperm(n_blocks, generator=g)
                         for _ in range(N_MIPS_QUERIES)])
    kw = dict(mesh=card_mesh(4), eps=EPS, delta=DELTA, value_range=vr,
              final_exact=True)
    kops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids, scores = sharded_mips_topk(V, Q, perms, K, **kw)
    torch.cuda.synchronize()
    call_ms = 1e3 * (time.perf_counter() - t0)
    launches = kops.launch_counts()["fused_cascade_batched[fp32]"]
    check(launches == 4 == kops.launch_counts()["fused_cascade_batched"],
          f"sharded mips: {launches} launches for 4 shards")
    with plain_route():
        ref = sharded_mips_topk(V, Q, perms, K, **kw)
    Qd = torch.from_numpy(Q).to(DEV)
    r = compare(V, Qd, (ids, scores), ref, what="sharded mips")
    exact = torch.topk(V @ Qd.T, K, dim=0).indices.T.cpu()
    recall = []
    for b in range(N_MIPS_QUERIES):
        check_served(V, Q[b], ids[b].cpu().numpy(), scores[b].cpu().numpy(),
                     n_valid, f"sharded mips: query {b}")
        recall.append(len(set(ids[b].tolist()) & set(exact[b].tolist()))
                      / K)
    res = {"launches": launches, "max_abs_err": r["max_abs_err"],
           "near_tie_queries": r["near_tie_queries"],
           "recall_at_k": float(np.mean(recall)), "call_ms": call_ms}
    say("sharded mips: " + json.dumps(res))
    return res


def phase_sharded(table, n_valid, served, kern) -> dict:
    """Phase 11: sharded serving on the one card; per tier tag the
    launches and errors of every run for the kernels line."""
    from repro_torch.launch import serve
    drawn = {}
    real_draw = serve.make_serving_table

    def drawn_once(cfg, seed=0, device="cuda"):
        # the CLI draws the same table for every run: draw it once (the
        # card's copy is the phase's, a CPU copy for the store runs)
        key = (cfg.name, seed, str(device))
        if key not in drawn:
            drawn[key] = ((table, n_valid) if str(device) == DEV
                          else real_draw(cfg, seed, device))
        return drawn[key]
    serve.make_serving_table = drawn_once
    runs = {}
    try:
        for tier in SHARD_TIERS:
            runs[(tier[0], tier[4])] = sharded_serve_run(*tier, served, kern)
            torch.cuda.empty_cache()
        runs["runtime"] = sharded_runtime_run(*TIERS[0], 4, dynamic=False)
        torch.cuda.empty_cache()
        for tier in STORE_RUNTIME_TIERS:
            runs[("store", tier[0])] = sharded_runtime_run(*tier, 4,
                                                           dynamic=True)
            torch.cuda.empty_cache()
    finally:
        serve.make_serving_table = real_draw
    runs["tenancy"] = sharded_tenancy_run()
    torch.cuda.empty_cache()
    runs["mips"] = sharded_mips_run(table.float(), n_valid)
    torch.cuda.empty_cache()
    per_tag = {}

    def add(tag, r):
        t = per_tag.setdefault(tag, {"launches": 0, "max_abs_err": 0.0})
        t["launches"] += r["launches"]
        t["max_abs_err"] = max(t["max_abs_err"], r["max_abs_err"])
    for (label, _), r in ((k, v) for k, v in runs.items()
                          if isinstance(k, tuple) and k[0] != "store"):
        add(tier_tag(label, table), r)
    add(tier_tag("fp32", table), runs["runtime"])
    for key in [k for k in runs if isinstance(k, tuple) and k[0] == "store"]:
        add(key[1], runs[key])
    add("fp32", runs["tenancy"])
    add("fp32", runs["mips"])
    return {"runs": runs, "per_tag": per_tag}


#: phase 12: the paper's Fig. 1 at the paper's own size
#: (``benchmarks/fig1_guarantee.py:5``; the script cuts it to (2000,
#: 20000) for the CPU): its 20 (eps, delta) pairs, 10 trials, seeds 1000 + t
FIG1_SHAPE = (10_000, 100_000)
FIG1_TRIALS = 10
FIG1_PAIRS = [(e, d) for e in (0.1, 0.2, 0.3, 0.45, 0.6)
              for d in (0.05, 0.1, 0.2, 0.3)]
#: the regime of ``benchmarks/fig23_synthetic.py`` and ``fig4_real.py``:
#: their shape, K, query count and seeds, and fig23's knobs (:40-86)
PAPER_SHAPE, PAPER_K, PAPER_QUERIES = (2000, 20_000), 5, 3
PAPER_EPS = (0.05, 0.1, 0.2, 0.4, 0.7, 1.0)
PAPER_LSH = ((12, 8), (8, 8), (6, 16), (4, 32))
PAPER_BUDGETS = (20, 100, 400, 1600)
PAPER_SPILLS = (0.0, 0.05, 0.2, 0.5)
#: ``benchmarks/table1_complexity.py:50-69``
TABLE1_SHAPE = (1000, 4096)


def adversarial_on_card(n: int, N: int, seed: int):
    """``adversarial_dataset(n, N, seed)`` built on the card from the same
    numpy draw of each row's count of ones: ``(R, ones)``."""
    rng = np.random.default_rng(seed)
    ones = np.rint(rng.uniform(0, 1, size=n) * N).astype(np.int64)
    R = (torch.arange(N, device=DEV)
         < torch.from_numpy(ones).to(DEV)[:, None]).to(torch.float32)
    return R, ones


def fig1_run() -> dict:
    """Theorem 1 at the paper's Fig. 1 size: each trial's R (4.0 GB, f32)
    built once on the card, all 20 pairs run on it, then freed."""
    from repro_torch.core.boundedme import bounded_me
    from repro_torch.core.schedule import make_schedule
    from repro_torch.data.synthetic import adversarial_dataset

    n, N = FIG1_SHAPE
    sched = {p: make_schedule(n, N, K=1, eps=p[0], delta=p[1])
             for p in FIG1_PAIRS}
    subopt = {p: [] for p in FIG1_PAIRS}
    call_ms = {p: [] for p in FIG1_PAIRS}
    t_phase = time.perf_counter()
    for t in range(FIG1_TRIALS):
        seed = 1000 + t
        R, ones = adversarial_on_card(n, N, seed)
        # a draw's first rows are a smaller draw's on the same seed
        check(torch.equal(R[:64], torch.from_numpy(
            adversarial_dataset(64, N, seed=seed)).to(DEV)),
              f"fig1: trial {t}: R on the card is not adversarial_dataset's")
        true = ones / N                  # each arm's exact mean
        if t == 0:
            bounded_me(R, K=1, eps=FIG1_PAIRS[0][0],
                       delta=FIG1_PAIRS[0][1])          # warm-up
            sum_ms = time_cuda(lambda: R.sum(dim=1), 10, 2)
        for p in FIG1_PAIRS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = bounded_me(R, K=1, eps=p[0], delta=p[1])
            torch.cuda.synchronize()
            call_ms[p].append(1e3 * (time.perf_counter() - t0))
            check(res.topk.device == R.device,
                  f"fig1 {p}: result on {res.topk.device}")
            check((res.total_pulls, res.rounds)
                  == (sched[p].total_pulls, len(sched[p].rounds)),
                  f"fig1 {p}: pulls {res.total_pulls} rounds {res.rounds} "
                  f"vs the schedule's {sched[p].total_pulls} "
                  f"{len(sched[p].rounds)}")
            subopt[p].append(float(true.max() - true[int(res.topk[0])]))
        del R
        torch.cuda.empty_cache()
    rows = []
    for eps, delta in FIG1_PAIRS:
        p = (eps, delta)
        quant = float(np.quantile(subopt[p], 1.0 - delta))
        check(quant < eps, f"fig1: Theorem 1 fails at eps {eps} delta "
              f"{delta}: the {1 - delta:g} quantile of the suboptimality "
              f"is {quant:.6g}")
        rows.append({"eps": eps, "delta": delta, "subopt_quantile": quant,
                     "pulls": sched[p].total_pulls,
                     "rounds": len(sched[p].rounds),
                     "ms": statistics.median(call_ms[p]),
                     "bound_ms": 4e3 * sched[p].total_pulls
                     / HBM_BYTES_PER_S})
        say("paper fig1: " + json.dumps(rows[-1]))
    out = {"rows": rows, "sum_ms": sum_ms,
           "sum_bound_ms": 4e3 * n * N / HBM_BYTES_PER_S,
           "seconds": time.perf_counter() - t_phase}
    say(f"paper fig1: Theorem 1 holds for all {len(rows)} (eps, delta) "
        f"pairs at {n} x {N} over {FIG1_TRIALS} trials; exact R.sum(1) "
        f"{sum_ms:.3f} ms (bound {out['sum_bound_ms']:.3f} ms); "
        f"{out['seconds']:.1f} s")
    return out


def paper_datasets():
    """The Figs. 2-4 tables and queries, with their scripts' seeds."""
    from repro_torch.data.synthetic import (gaussian_dataset, mf_dataset,
                                            uniform_dataset)
    n, N = PAPER_SHAPE
    for name, gen in (("gaussian", gaussian_dataset),
                      ("uniform", uniform_dataset)):
        yield name, gen(n, N, seed=0)[0], [
            gen(1, N, seed=100 + i)[1] for i in range(PAPER_QUERIES)]
    yield "mf", mf_dataset(n, N, rank=32, seed=0)[0], [
        mf_dataset(1, N, rank=32, seed=50 + i)[1]
        for i in range(PAPER_QUERIES)]


def paper_sweep(V: np.ndarray, queries, device: str) -> dict:
    """Every method and knob of the Figs. 2-4 sweep on ``device``: per
    row, each query's returned ids and cost, and the card's ms per call."""
    from repro_torch.baselines import (build_greedy, build_lsh,
                                       build_pca_tree, exact_mips,
                                       greedy_mips, lsh_mips, pca_mips)
    from repro_torch.core.boundedme import bounded_me, reward_matrix

    Vd = torch.from_numpy(V).to(device)
    qs = [torch.from_numpy(q).to(device) for q in queries]
    rng = np.random.default_rng(0)
    perms = [rng.permutation(V.shape[1]) for _ in qs]
    vrange = [float(np.abs(V).max() * np.abs(q).max()) for q in queries]
    truth = [exact_mips(Vd, q, PAPER_K).topk.tolist() for q in qs]
    rows = {}

    def row(name, call):
        recs, ms = [], []
        for i in range(len(qs)):
            t0 = time.perf_counter()
            ids, cost = call(i)
            if device != "cpu":
                torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            recs.append((ids.tolist(), cost))
        rows[name] = {"recs": recs, "ms": statistics.median(ms)}

    for eps in PAPER_EPS:
        def bme(i, eps=eps):
            R = reward_matrix(Vd, qs[i], perms[i])
            r = bounded_me(R, K=PAPER_K, eps=eps * vrange[i], delta=0.1,
                           value_range=2 * vrange[i])
            return r.topk, r.total_pulls
        row(f"boundedme_eps{eps}", bme)
    for a, b in PAPER_LSH:
        index = build_lsh(Vd, a=a, b=b, seed=1)
        row(f"lsh_a{a}_b{b}", lambda i: (
            (r := lsh_mips(index, qs[i], PAPER_K)).topk, r.query_multiplies))
    gidx = build_greedy(Vd)
    for budget in PAPER_BUDGETS:
        row(f"greedy_B{budget}", lambda i: (
            (r := greedy_mips(gidx, qs[i], PAPER_K, budget=budget)).topk,
            r.query_multiplies))
    tree = build_pca_tree(Vd, depth=8)
    for spill in PAPER_SPILLS:
        row(f"pca_spill{spill}", lambda i: (
            (r := pca_mips(tree, qs[i], PAPER_K, spill=spill)).topk,
            r.query_multiplies))
    naive = V.shape[0] * V.shape[1]
    for name, r in rows.items():
        r["speedup"] = float(np.mean([naive / max(1, c)
                                      for _, c in r["recs"]]))
        r["precision"] = float(np.mean([
            len(set(ids) & set(t)) / PAPER_K
            for (ids, _), t in zip(r["recs"], truth)]))
    return {"rows": rows, "components": tree.components.cpu(),
            "leaves": paper_leaves(tree)}


def paper_leaves(tree) -> set:
    """A PCA tree's leaves as sets of row ids."""
    out, stack = set(), [tree.root]
    while stack:
        node = stack.pop()
        if node.ids is not None:
            out.add(frozenset(node.ids.tolist()))
        else:
            stack += [node.left, node.right]
    return out


def paper_compare(label: str, card: dict, cpu: dict, V: np.ndarray,
                  queries) -> dict:
    """Hold each row of the card's sweep against the CPU's: the same ids
    and costs per query, but where the two SVDs' trees differ (PCA rows)
    or the two id sets tie (their exact float64 scores within 1e-5
    relative, position by position; costs still equal)."""
    V64 = torch.from_numpy(V).double()
    same_tree = card["leaves"] == cpu["leaves"]
    ties, svd = [], []
    for name, c in card["rows"].items():
        p = cpu["rows"][name]
        if c["recs"] == p["recs"]:
            continue
        if name.startswith("pca"):
            check(not same_tree, f"paper {label} {name}: card {c['recs']} "
                  f"vs cpu {p['recs']} on equal trees")
            svd.append(name)
            continue
        for i, ((ids_c, cost_c), (ids_p, cost_p)) in enumerate(
                zip(c["recs"], p["recs"])):
            check(cost_c == cost_p, f"paper {label} {name} query {i}: cost "
                  f"{cost_c} on the card vs {cost_p} on the CPU")
            q64 = torch.from_numpy(queries[i]).double()
            sc, sp = V64[ids_c] @ q64, V64[ids_p] @ q64
            check(len(ids_c) == len(ids_p) and torch.allclose(
                sc, sp, rtol=1e-5, atol=0.0),
                  f"paper {label} {name} query {i}: ids {ids_c} (exact "
                  f"{sc.tolist()}) vs {ids_p} ({sp.tolist()})")
        ties.append(name)
    flips = int((card["components"].double() * cpu["components"].double()
                 ).sum(dim=1).lt(0).sum())
    for name, c in card["rows"].items():
        say(f"paper {label} {name}: speedup {c['speedup']:.6g} precision "
            f"{c['precision']:.6g} (cpu {cpu['rows'][name]['speedup']:.6g}"
            f" / {cpu['rows'][name]['precision']:.6g}) {c['ms']:.3f} ms "
            f"per call on the card")
    wins = {}
    for level in (1.0, 0.8, 0.6):
        best = max(((c["speedup"], n) for n, c in card["rows"].items()
                    if c["precision"] >= level - 1e-9), default=None)
        wins[level] = best and {"method": best[1], "speedup": best[0]}
    out = {"tie_rows": ties, "svd_rows": svd, "sign_flips": flips,
           "same_tree": same_tree, "wins": wins,
           "rows": {n: {k: c[k] for k in ("speedup", "precision", "ms")}
                    for n, c in card["rows"].items()}}
    say(f"paper {label}: {len(ties)} tie rows {ties}, {len(svd)} PCA rows "
        f"off the CPU's tree {svd} ({flips} of the 8 components' signs "
        f"flipped, leaves equal: {same_tree}); fastest at precision >= "
        f"level: {json.dumps(wins)}")
    return out


def table1_run() -> dict:
    """Table 1's rows: the baselines' preprocessing on the card against
    BoundedME's none, and BoundedSE against BoundedME pull counts, which
    must equal the CPU's."""
    from repro_torch.baselines import build_greedy, build_lsh, build_pca_tree
    from repro_torch.core.bounded_se import bounded_se
    from repro_torch.core.boundedme import bounded_me
    from repro_torch.data.synthetic import (adversarial_dataset,
                                            gaussian_dataset)

    V = torch.from_numpy(gaussian_dataset(*TABLE1_SHAPE, seed=0)[0]).to(DEV)
    builds = {"lsh": lambda: build_lsh(V, a=8, b=16),
              "greedy": lambda: build_greedy(V),
              "pca": lambda: build_pca_tree(V, depth=6)}
    secs = {"boundedme": 0.0}
    for name, build in builds.items():
        build()                                   # warm-up
        ts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            build()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        secs[name] = statistics.median(ts)
    rng = np.random.default_rng(0)
    means = np.full(400, 0.3)
    means[0] = 0.7
    R_easy = (rng.uniform(0, 1, (400, 4000)) < means[:, None]).astype(
        np.float32)
    R_adv = rng.permuted(adversarial_dataset(400, 4000, seed=9), axis=1)
    pulls = {}
    for tag, R in (("easy", R_easy), ("adversarial", R_adv)):
        got = {}
        for dev in (DEV, "cpu"):
            me = bounded_me(R, K=1, eps=0.05, delta=0.1, device=dev)
            se = bounded_se(R, K=1, eps=0.05, delta=0.1, device=dev)
            got[dev] = (me.total_pulls, se.total_pulls, me.topk.tolist(),
                        se.topk.tolist())
        check(got[DEV] == got["cpu"], f"table1 boundedse_{tag}: card "
              f"{got[DEV]} vs cpu {got['cpu']}")
        me_p, se_p = got[DEV][:2]
        pulls[tag] = {"me_pulls": me_p, "se_pulls": se_p,
                      "se_speedup": me_p / max(1, se_p)}
    out = {"preprocessing_s": secs, "boundedse": pulls}
    say("paper table1: " + json.dumps(out))
    return out


def phase_paper() -> dict:
    """Phase 12: the paper's algorithms and baselines on the card (plain
    PyTorch ops: no kernel of the port runs here)."""
    from repro_torch.kernels import ops as kops

    t0 = time.perf_counter()
    kops.reset_launch_counts()
    out = {"fig1": fig1_run(), "figs": {}}
    for label, V, queries in paper_datasets():
        card, cpu = (paper_sweep(V, queries, dev) for dev in (DEV, "cpu"))
        out["figs"][label] = paper_compare(label, card, cpu, V, queries)
    out["table1"] = table1_run()
    launched = sum(kops.launch_counts().values())
    check(launched == 0, f"paper: {launched} kernel launches")
    out["seconds"] = time.perf_counter() - t0
    say(f"paper: all rows held in {out['seconds']:.1f} s")
    return out


#: phase 14: the trainer at its CLI defaults (batch 8, seq 128, lr 1e-3)
TRAIN_ARCH, TRAIN_STEPS = "tinyllama-1.1b", 16
#: phase 14's resume: full width, 2 layers, 8 steps halted at 4
RESUME_LAYERS, RESUME_STEPS, RESUME_HALT = 2, 8, 4
#: phase 14's card against the CPU: the smoke configs in f32, 3 steps
TRAIN_CARD_CPU = (("tinyllama-1.1b", "qwen3-moe-30b-a3b"), 3, 1e-3)


def train_args(*extra: str):
    from repro_torch.launch import train as T
    return T.parse_args(["--arch", TRAIN_ARCH, "--device", DEV,
                         "--log-every", "4", *extra])


@contextlib.contextmanager
def timed_checkpoints():
    """Record each checkpoint the trainer writes or reads: ``(what,
    seconds, GB on disk)`` (the host clock around the call)."""
    import os
    from repro_torch.launch import train as T
    calls, real = [], (T.save_checkpoint, T.restore_checkpoint)

    def saving(ckpt_dir, step, tree, **kw):
        t0 = time.perf_counter()
        path = real[0](ckpt_dir, step, tree, **kw)
        calls.append(("write", time.perf_counter() - t0, os.path.getsize(
            os.path.join(path, "shard_0.npz")) / 1e9))
        return path

    def reading(ckpt_dir, tree_like, step=None):
        t0 = time.perf_counter()
        out = real[1](ckpt_dir, tree_like, step)
        calls.append(("read", time.perf_counter() - t0, os.path.getsize(
            os.path.join(ckpt_dir, f"step_{out[1]:08d}", "shard_0.npz"))
            / 1e9))
        return out
    T.save_checkpoint, T.restore_checkpoint = saving, reading
    try:
        yield calls
    finally:
        T.save_checkpoint, T.restore_checkpoint = real


def train_full() -> dict:
    """Phase 14 (a): tinyllama-1.1b at full width and depth in bf16
    through the trainer at the CLI's defaults for `TRAIN_STEPS` steps."""
    from repro_torch.launch import train as T
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    args = train_args("--steps", str(TRAIN_STEPS))
    t0 = time.perf_counter()
    res = T.train(args)
    run_s = time.perf_counter() - t0
    cfg, model, hist = res["cfg"], res["model"], res["history"]
    losses = [h["loss"] for h in hist]
    check(len(hist) == TRAIN_STEPS and all(np.isfinite(losses)),
          f"train: losses {losses}")
    check(losses[-1] < losses[0],
          f"train: the loss did not fall ({losses[0]:.4f} -> "
          f"{losses[-1]:.4f})")
    check(cfg.n_layers == 22 and cfg.dtype == "bfloat16" and cfg.remat,
          f"train: {cfg.n_layers} layers in {cfg.dtype}, remat {cfg.remat}")
    n_params = sum(p.numel() for p in model.parameters())
    # matmul FLOPs of a step: 6 per weight of every matmul and token
    # (forward, both backward products); the embedding is a lookup, and
    # remat's second forward is not counted
    tokens = args.batch * args.seq
    mm = sum(p.numel() for n, p in model.named_parameters()
             if p.dim() >= 2 and n != "embed")
    step_ms = statistics.median(res["step_s"][2:]) * 1e3
    out = {
        "arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype,
        "remat": cfg.remat, "batch": args.batch, "seq": args.seq,
        "steps": len(hist), "params": n_params,
        "weights_gb": sum(p.numel() * p.element_size()
                          for p in model.parameters()) / 1e9,
        "moments_gb": sum(t.numel() * t.element_size()
                          for t in (*res["opt"].mu.values(),
                                    *res["opt"].nu.values())) / 1e9,
        "losses": losses, "loss_fell_by": losses[0] - losses[-1],
        "grad_norm_first_last": [hist[0]["grad_norm"],
                                 hist[-1]["grad_norm"]],
        "step0_ms": res["step_s"][0] * 1e3, "step1_ms": res["step_s"][1] * 1e3,
        "ms_per_step": step_ms,
        "ms_per_step_spread": [min(res["step_s"][2:]) * 1e3,
                               max(res["step_s"][2:]) * 1e3],
        "tokens_per_s": tokens / step_ms * 1e3,
        "matmul_tflop_per_step": 6 * mm * tokens / 1e12,
        "matmul_tflops": 6 * mm * tokens / step_ms / 1e9,
        "run_s": run_s, "mem_before_gb": base_gb,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    say("train tinyllama-1.1b: " + json.dumps(out))
    return res, out


def train_serve(res) -> dict:
    """Phase 14 (b): the trained model in the decode demo, the bandit
    head (every launch held) and the exact head."""
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import serve
    model = res["model"]
    check(all(p.requires_grad for p in model.parameters()),
          "train serve: the trained parameters do not require grad")
    serve.run_decode_demo(decode_args(TRAIN_ARCH, "boundedme", 2),
                          model=model)
    args = decode_args(TRAIN_ARCH, "boundedme")
    kops.reset_launch_counts()
    with recording_heads() as calls:
        out_b = serve.run_decode_demo(args, model=model)
    counts = kops.launch_counts()
    launches = counts["fused_cascade_batched[bf16]"]
    check(launches == args.tokens == counts["fused_cascade_batched"]
          == len(calls),
          f"train serve: {launches} fused_cascade_batched[bf16] launches "
          f"({counts['fused_cascade_batched']} in all, {len(calls)} head "
          f"calls) for {args.tokens} decode steps")
    cfg, table = out_b["cfg"], model.head_table
    check(cfg.n_layers == 22 and table is model.unembed,
          "train serve: not the trained 22-layer model's unembedding")
    held = hold_head_steps("trained tinyllama-1.1b", calls, cfg, table)
    exact = serve.run_decode_demo(decode_args(TRAIN_ARCH, "exact"),
                                  model=model)
    out = {**held, "launches": launches, "layers": cfg.n_layers,
           "token_agreement_with_exact": float(
               (out_b["tokens"] == exact["tokens"]).mean()),
           "prefill_ms": out_b["prefill_ms"],
           "ms_per_token": out_b["ms_per_token"],
           "exact_ms_per_token": exact["ms_per_token"],
           "head": head_launch(calls, cfg, table, widened=True)}
    say("train serve: " + json.dumps(out))
    return out


def train_resume() -> dict:
    """Phase 14 (c): at full width and `RESUME_LAYERS` layers, the
    trainer run whole for `RESUME_STEPS` steps against a run halted at
    `RESUME_HALT`, checkpointed and restarted, under deterministic
    algorithms: parameters and moments bitwise."""
    import os
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.launch import train as T
    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              n_layers=RESUME_LAYERS)
    steps = ["--steps", str(RESUME_STEPS)]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    ckpt = ["--ckpt-dir", tmp, "--ckpt-every", str(RESUME_HALT)]
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        t0 = time.perf_counter()
        whole = T.train(train_args(*steps), cfg=cfg)
        whole_s = time.perf_counter() - t0
        with timed_checkpoints() as io:
            t0 = time.perf_counter()
            part = T.train(train_args(*steps, *ckpt), cfg=cfg,
                           halt_at=RESUME_HALT)
            del part
            torch.cuda.empty_cache()
            rest = T.train(train_args(*steps, *ckpt), cfg=cfg)
            split_s = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env
        shutil.rmtree(tmp, ignore_errors=True)
    check(rest["start"] == RESUME_HALT,
          f"train resume: restarted at {rest['start']}")
    check([h["loss"] for h in rest["history"]]
          == [h["loss"] for h in whole["history"][RESUME_HALT:]],
          "train resume: losses after the restart differ")
    wp = dict(whole["model"].named_parameters())
    diff = [n for n, p in rest["model"].named_parameters()
            if not torch.equal(p, wp[n])]
    diff += [f"{f}/{n}" for f in ("mu", "nu") for n, t in getattr(
        rest["opt"], f).items() if not torch.equal(t, getattr(
            whole["opt"], f)[n])]
    check(not diff, f"train resume: not bitwise: {diff[:5]}")
    check([c[0] for c in io] == ["write", "read", "write"],
          f"train resume: checkpoint calls {[c[0] for c in io]}")
    out = {"layers": RESUME_LAYERS, "steps": RESUME_STEPS,
           "halted_at": RESUME_HALT, "bitwise": True,
           "params_and_moments": len(wp) * 3,
           "checkpoints": [{"op": op, "s": s, "gb": gb,
                            "gb_per_s": gb / s} for op, s, gb in io],
           "whole_s": whole_s, "halted_and_resumed_s": split_s}
    say("train resume: " + json.dumps(out))
    del whole, rest, wp
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_card_vs_cpu() -> dict:
    """Phase 14 (d): `train_step` on the card against the CPU at the smoke
    size in f32, from the same weights and batches: losses to rtol 1e-5,
    gradient norms to rtol 1e-4; all but 0.1 % of the parameters to rtol
    1e-4 with atol lr / 100 (a hundredth of one update), and every one
    within 2 lr a step: an AdamW update keeps about the sign of a
    gradient whose size is near ``eps`` or near the two devices'
    difference (``tests/test_torch_train_cuda.py``)."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import LMStream
    from repro_torch.models.model import build_model
    from repro_torch.models.steps import train_step
    from repro_torch.optim.adamw import AdamWConfig, init_opt
    archs, n_steps, lr = TRAIN_CARD_CPU
    out = {}
    for arch in archs:
        cfg = get_config(arch).smoke()
        host = build_model(cfg, seed=3, device="cpu")
        card = copy.deepcopy(host).to(DEV)
        opt_cfg = AdamWConfig(lr=lr, warmup_steps=1, total_steps=10)
        stream = LMStream(cfg.vocab, batch=4, seq=32, seed=0)
        opts = {"cpu": init_opt(dict(host.named_parameters())),
                "card": init_opt(dict(card.named_parameters()))}
        rec = {"loss_rel_err": 0.0, "grad_norm_rel_err": 0.0}
        for step in range(n_steps):
            ms = {}
            for name, m in (("cpu", host), ("card", card)):
                b = {k: torch.from_numpy(v).to(m.embed.device)
                     for k, v in stream.batch_at(step).items()}
                _, opts[name], ms[name] = train_step(m, opts[name], b, cfg,
                                                     opt_cfg)
            for k in ("loss", "grad_norm"):
                a, c = float(ms["card"][k]), float(ms["cpu"][k])
                rec[f"{k}_rel_err"] = max(rec[f"{k}_rel_err"],
                                          abs(a - c) / abs(c))
        check(rec["loss_rel_err"] <= 1e-5 and rec["grad_norm_rel_err"]
              <= CARD_CPU_RTOL, f"train card vs cpu {arch}: {rec}")
        off = past_rtol = n = 0
        worst = 0.0
        for (k, a), (_, c) in zip(card.named_parameters(),
                                  host.named_parameters()):
            d = (a.detach().cpu() - c.detach()).abs()
            ref = CARD_CPU_RTOL * c.detach().abs()
            worst = max(worst, float(d.max()))
            past_rtol += int((d > ref).sum())
            off += int((d > ref + 1e-2 * lr).sum())
            n += d.numel()
        check(worst <= 2 * lr * n_steps and off <= 1e-3 * n,
              f"train card vs cpu {arch}: {off} of {n} parameters past "
              f"rtol {CARD_CPU_RTOL} and atol lr / 100, largest gap "
              f"{worst:.3g}")
        out[arch] = {**rec, "steps": n_steps, "params": n,
                     "params_past_rtol_and_atol": off,
                     "params_past_rtol_alone": past_rtol,
                     "param_max_abs_err": worst, "rtol": CARD_CPU_RTOL,
                     "atol": 1e-2 * lr}
        say(f"train card vs cpu {arch}: " + json.dumps(out[arch]))
        del host, card, opts
    torch.cuda.empty_cache()
    return out


#: phase 14 (e): qwen1.5-0.5b ([hf:Qwen/Qwen1.5-0.5B]) at full width,
#: its qkv biases bf16, 2 of 24 layers, one step at the trainer's B = 8,
#: S = 128, on one card and on a simulated 'data' mesh
BIAS_ARCH, BIAS_LAYERS, BIAS_MESH = "qwen1.5-0.5b", 2, (4, 1)
#: (leading dims, W) the chain kernel is held at against its plain
#: version: the step's cotangent (1,024 rows of 1,024), whisper-medium's
#: widths (its d_ff 4,096), one row, a width off a warp, four leading
#: dimensions past XLA's window (two passes), mamba2-130m's ``D`` skip
#: in phase 17 (d) (B, S and its head dim 64 summed, its 24 heads kept)
CHAIN_SHAPES = (((8, 128), 1024), ((8, 128), 4096), ((1,), 1024),
                ((8, 128), 1000), ((3, 45, 2, 5), 77), ((8, 128, 64), 24))


def chain_apart(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest ``|got - want|`` of two chain sums, in f32 (0 where
    they are bitwise)."""
    return float((got.float() - want.float()).abs().max()) if got.numel() \
        else 0.0


def plain_chain(g: torch.Tensor, reduced) -> torch.Tensor:
    """`_chain_grad`'s sum of ``g`` over its dimensions ``reduced`` by the
    plain version (`ref.chain_sum_ref`), the others kept in order."""
    from repro_torch.kernels import ref
    kept = [d for d in range(g.dim()) if d not in reduced]
    t = g.permute(*reduced, *kept)
    lead = t.shape[:len(reduced)]
    return ref.chain_sum_ref(t.reshape(*lead, -1).contiguous()).reshape(
        t.shape[len(reduced):])


def chain_kernel_hold() -> dict:
    """Phase 14 (e), first part: the chain-sum kernel bitwise its plain
    version at `CHAIN_SHAPES`, and on a strided input (the entry point
    makes it contiguous; the wrapper refuses it); then timed back to back
    (`time_back_to_back`: device time) at the step's shape and at
    mamba2's ``D`` shape against its plain version, its bound (its bytes
    over the card's memory rate) and ``torch.sum`` over the rows (a
    yardstick only: it rounds once, another function)."""
    from repro_torch.kernels import chain_sum as cs
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    rng = np.random.default_rng(11)
    apart = 0.0
    for lead, W in CHAIN_SHAPES:
        g = torch.from_numpy(rng.normal(size=(*lead, W)).astype(
            np.float32)).to(DEV, torch.bfloat16)
        got, want = kops.chain_sum(g), ref.chain_sum_ref(g)
        apart = max(apart, chain_apart(got, want))
        check(torch.equal(got, want),
              f"chain_sum {lead} x {W}: the kernel is not its plain version")
    g = torch.from_numpy(rng.normal(size=(1024, 768)).astype(
        np.float32)).to(DEV, torch.bfloat16)
    got, want = kops.chain_sum(g.t()), ref.chain_sum_ref(g.t().contiguous())
    apart = max(apart, chain_apart(got, want))
    check(torch.equal(got, want),
          "chain_sum on a strided input is not the plain version's")
    try:
        cs.chain_sum_cuda(g.t())
        check(False, "chain_sum_cuda took a strided input")
    except ValueError:
        pass
    timed = {}
    for what, (lead, W) in (("step", CHAIN_SHAPES[0]),
                            ("mamba2_D", CHAIN_SHAPES[-1])):
        g = torch.from_numpy(rng.normal(size=(*lead, W)).astype(
            np.float32)).to(DEV, torch.bfloat16)
        dims = tuple(range(len(lead)))
        timed[what] = {
            "shape": [*lead, W], "passes": len(cs.passes(lead)),
            "ms": time_back_to_back(lambda: kops.chain_sum(g)),
            "plain_ms": time_cuda(lambda: ref.chain_sum_ref(g), 3, 1),
            "library_ms": time_back_to_back(lambda: torch.sum(g, dims)),
            "bound_ms": (2 * g.numel() + 2 * W) / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes"}
    out = {**timed["step"], "dtype": "bfloat16", "mamba2_D": timed[
        "mamba2_D"], "max_abs_err": apart, "held_shapes": [
            [*lead_, W_] for lead_, W_ in CHAIN_SHAPES] + [[768, 1024]]}
    say("train bias chain kernel: " + json.dumps(out))
    return out


def embed_scatter_hold() -> dict:
    """Phase 14 (e), last: the audit's other bf16 accumulation (ROADMAP
    3.5), the gradient of a bf16 gather, which the JAX package's program
    runs as a bf16 scatter-add (one rounding per repeated index, in index
    order; the port's CPU index backward is bitwise that): an embedding
    lookup ``table[tokens]`` (8 x 128 tokens over 512 rows, many repeats)
    and the MoE dispatch's sorted token gather (each of 16 tokens 4
    times), on the card bitwise the CPU."""
    rng = np.random.default_rng(12)
    out = {}
    for what, rows, index in (("embed", 512, (8, 128)),
                              ("moe_token", 16, (64,))):
        table = torch.from_numpy(rng.normal(size=(rows, 1024)).astype(
            np.float32)).to(torch.bfloat16)
        idx = rng.integers(0, rows, index)
        if what == "moe_token":
            idx = np.sort(idx)
        cot = torch.from_numpy(rng.normal(size=(*index, 1024)).astype(
            np.float32)).to(torch.bfloat16)
        grads = []
        for dev in ("cpu", DEV):
            t = table.to(dev).requires_grad_(True)
            (g,) = torch.autograd.grad(t[torch.from_numpy(idx).to(dev)],
                                       [t], grad_outputs=[cot.to(dev)])
            grads.append(g.float().cpu())
        apart = int((grads[0] != grads[1]).sum())
        check(apart == 0, f"train bias {what} gather's gradient: {apart} "
              f"of {grads[0].numel()} apart from the CPU's")
        out[what] = {"rows": rows, "index": list(index),
                     "max_repeats": int(np.bincount(idx.ravel()).max())}
    say("train bias gather transposes, card bitwise cpu: " + json.dumps(out))
    return out


def train_bias_chain() -> dict:
    """Phase 14 (e): one trainer step of `BIAS_ARCH` at full width and
    `BIAS_LAYERS` layers in bf16, on one card and on a `BIAS_MESH` mesh
    simulated on the card, each with the launch counts set to 0 just
    before and read just after.  Each bias's cotangent is recorded by a
    hook on its `bias_add`'s output, keyed by the bias; every bias
    gradient of the one-card step must be bitwise the plain version's
    chain of its own cotangent over the whole batch (the step's sum is
    the kernel's), every one of the mesh's bitwise the f32 sum of the
    ranks' plain chains of their rows of its cotangent, rounded once;
    the kernel launched once per pass for each bias, and for each
    simulated rank."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import chain_sum as cs
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import simulated_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import steps as ST
    t_sub = time.perf_counter()
    out = {"kernel": chain_kernel_hold(), "arch": BIAS_ARCH,
           "layers": BIAS_LAYERS, "batch": 8, "seq": 128}
    cfg = dataclasses.replace(get_config(BIAS_ARCH), n_layers=BIAS_LAYERS,
                              dtype="bfloat16")
    args = T.parse_args(["--arch", BIAS_ARCH, "--device", DEV, "--steps",
                         "1", "--batch", "8", "--seq", "128"])
    real = L._chain_grad, ST._as_param, L.bias_add
    apart = 0.0
    for where, shape in (("one_card", None), ("mesh", BIAS_MESH)):
        t0 = time.perf_counter()
        calls, cots, grads = [], {}, {}

        def chain_grad(g, reduced):
            check(reduced == (0, 1),
                  f"train bias {where}: a chain over dims {reduced}")
            calls.append(reduced)
            return real[0](g, reduced)

        def as_param(g, p):
            o = real[1](g, p)
            grads[id(p)] = o.detach()
            return o

        def bias_add(x, b):
            y = real[2](x, b)
            if y.requires_grad:
                y.register_hook(lambda g, key=id(b): cots.setdefault(
                    key, []).append(g.detach()))
            return y
        L._chain_grad, ST._as_param, L.bias_add = chain_grad, as_param, \
            bias_add
        ranks = 1 if shape is None else shape[0] * shape[1]
        try:
            ctx = (contextlib.nullcontext() if shape is None
                   else simulated_mesh(shape, device=DEV))
            with ctx as mesh:
                kops.reset_launch_counts()
                res = T.train(args, cfg=cfg, mesh=mesh)
                launches = kops.launch_counts()["chain_sum"]
                names = {id(p): n for n, p in res["model"].named_parameters()}
                got = {names[i]: gathered(g) for i, g in grads.items()
                       if names[i].rsplit(".", 1)[-1] in ("bq", "bk", "bv")}
                fired = {names.get(i, str(i)): len(gs)
                         for i, gs in cots.items()}
                cot = {names[i]: gathered(gs[0]) for i, gs in cots.items()
                       if i in names}
                history, step_s = res["history"], res["step_s"]
                del res
        finally:
            L._chain_grad, ST._as_param, L.bias_add = real
        n_bias = 3 * BIAS_LAYERS
        check(len(got) == n_bias == len(calls)
              and sorted(cot) == sorted(got)
              and set(fired.values()) == {1},
              f"train bias {where}: {len(got)} bias gradients {sorted(got)}, "
              f"{len(calls)} chain sums, cotangents {fired}, {n_bias} biases")
        for name, g in cot.items():
            rows = g.shape[0] // ranks
            total = ref.chain_sum_ref(g[:rows]).float()
            for r in range(1, ranks):
                total = total + ref.chain_sum_ref(
                    g[r * rows:(r + 1) * rows]).float()
            want = total.to(g.dtype)
            apart = max(apart, chain_apart(got[name], want))
            check(torch.equal(got[name], want),
                  f"train bias {where}: {name}'s gradient is not the f32 "
                  f"sum of the ranks' chains of its cotangent "
                  f"({chain_apart(got[name], want)} apart)")
        local = (rows, *g.shape[1:-1])
        passes = len(cs.passes(local))
        check(launches == n_bias * passes * ranks,
              f"train bias {where}: {launches} chain_sum launches for "
              f"{n_bias} biases x {passes} passes x {ranks} ranks")
        rec = {"launches": launches, "biases": n_bias, "ranks": ranks,
               "passes": passes, "local_rows": list(local),
               "loss": history[0]["loss"], "step_ms": step_s[0] * 1e3,
               "seconds": time.perf_counter() - t0}
        out[where] = rec
        say(f"train bias {where}: " + json.dumps(rec))
        del got, cot, cots, grads
        gc.collect()
        torch.cuda.empty_cache()
    out["launches"] = out["one_card"]["launches"] + out["mesh"]["launches"]
    out["max_abs_err"] = max(apart, out["kernel"]["max_abs_err"])
    out["gather_transposes"] = embed_scatter_hold()
    out["seconds"] = time.perf_counter() - t_sub
    say(f"train bias: sub-phase in {out['seconds']:.1f} s")
    return out


#: phase 14 (f): the autograd Functions whose backward is the JAX
#: package's op for op, at the shapes the trainer hands them: SwiGLU's
#: silu at tinyllama-1.1b's step (B = 8, S = 128, its d_ff 5,632) in bf16,
#: mamba2-130m's f32 gate (its d_inner 1,536), and the MoE's top-k gate
#: renormalization at qwen3-moe-30b-a3b's (k = 8 of 128 experts)
BACKWARD_FUNCTIONS = (("silu", (8, 128, 5632), "bfloat16"),
                      ("silu", (8, 128, 1536), "float32"),
                      ("renorm", (8, 128, 8), "float32"))


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Each element's distance in bf16 ulps of two bf16 tensors."""
    def key(x):
        i = x.float().view(torch.int32).to(torch.int64) >> 16
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (key(a) - key(b)).abs()


def train_backward_functions() -> dict:
    """Phase 14 (f): each Function of `BACKWARD_FUNCTIONS` (`_Silu`,
    `_Renorm` in `repro_torch.models.layers`), forward and backward on
    the card against the same Function on the CPU, from the same seeded
    inputs and cotangent.  Every op of these backwards but ``exp`` is
    correctly rounded on both (products, sums, quotients, each rounding
    to the type), so in bf16 the card's silu gradient must be bitwise the
    CPU's computed on the card's sigmoid values (`_sigmoid` handed the
    card's result); how far it is from the CPU's own (the two ``exp``
    differ by an f32 ulp at times, which a bf16 rounding can turn into
    one bf16 ulp of the sigmoid and more of the gradient) is printed:
    the elements whose sigmoid differs, the elements apart, those more
    than one bf16 ulp apart and the most.  In f32 the rule is every
    element within 2^-20 of the gradient's largest (8 ulps there): the
    card's ``exp``, its summation order and whether its ``addcmul`` fuses
    its multiply-add are its own; whether the f32 silu is bitwise on the
    card's sigmoid is printed.  Each Function's forward and backward is
    timed on the card (`time_back_to_back`) beside autograd's derivative
    of the same forward."""
    from repro_torch.models import layers as L
    t_sub = time.perf_counter()
    rng = np.random.default_rng(14)
    out = {}
    for name, shape, dtype in BACKWARD_FUNCTIONS:
        dt = getattr(torch, dtype)
        a = rng.normal(size=shape)
        a = 0.3 * np.abs(a) if name == "renorm" else 2 * a
        a = torch.from_numpy(a.astype(np.float32)).to(dt)
        b = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dt)
        fn = L._silu if name == "silu" else L._renorm

        def plain(x, name=name):
            return (x * (1 / (1 + torch.exp(-x))) if name == "silu"
                    else x / torch.clamp(x.sum(-1, keepdim=True), min=1e-9))

        def grad(x, cot, f=fn):
            x = x.detach().requires_grad_(True)
            return torch.autograd.grad(f(x), [x], [cot])[0]
        card = grad(a.to(DEV), b.to(DEV)).cpu()
        want = grad(a, b)
        rec = {"function": "_Silu" if name == "silu" else "_Renorm",
               "shape": list(shape), "dtype": dtype,
               "apart": int((card != want).sum())}
        if name == "silu":
            sig = L._sigmoid(a.to(DEV)).cpu()
            real = L._sigmoid
            L._sigmoid = lambda x, sig=sig: sig
            try:
                given = grad(a, b)
            finally:
                L._sigmoid = real
            rec["sigmoid_apart"] = int((sig != real(a)).sum())
            rec["bitwise_on_card_sigmoid"] = bool(torch.equal(card, given))
        if dtype == "bfloat16":
            u = bf16_ulps(card, want)
            rec.update(past_one_ulp=int((u > 1).sum()), max_ulps=int(u.max()))
            check(rec["bitwise_on_card_sigmoid"],
                  f"train backward {name} {dtype}: the card's gradient is "
                  f"not the CPU's on the card's sigmoid values "
                  f"({int((card != given).sum())} apart)")
        else:
            gap = float((card - want).abs().max())
            rec["max_abs_err"] = gap
            check(gap <= 2.0 ** -20 * float(want.abs().max()),
                  f"train backward {name} {dtype}: {gap} from the CPU's, "
                  f"past 2^-20 of its largest {float(want.abs().max())}")
        x, cot = a.to(DEV), b.to(DEV)
        rec["ms"] = time_back_to_back(lambda: grad(x, cot), n=10, reps=3)
        rec["autograd_ms"] = time_back_to_back(lambda: grad(x, cot, plain),
                                               n=10, reps=3)
        out[f"{name}_{dtype}"] = rec
        say(f"train backward {name} {dtype}: " + json.dumps(rec))
        del a, b, card, want, x, cot
    out["seconds"] = time.perf_counter() - t_sub
    say(f"train backward: sub-phase in {out['seconds']:.1f} s")
    torch.cuda.empty_cache()
    return out


def phase_train() -> dict:
    """Phase 14: the trainer on the card — tinyllama-1.1b at full width and
    depth, then served with the bandit head; the resume; the card
    against the CPU."""
    t_phase = time.perf_counter()
    res, full = train_full()
    res.pop("opt")                    # serving needs only the model
    gc.collect()
    torch.cuda.empty_cache()
    served = train_serve(res)
    del res
    gc.collect()
    torch.cuda.empty_cache()
    out = {"full": full, "serve": served, "resume": train_resume(),
           "card_vs_cpu": train_card_vs_cpu(),
           "bias_chain": train_bias_chain(),
           "backward_functions": train_backward_functions()}
    say(f"train: phase in {time.perf_counter() - t_phase:.1f} s")
    return out


#: phase 15: the meshes of (a), their ranks simulated on the one card
SHARDED_MESHES = ((2, 1), (1, 2), (2, 2))
#: phase 15 (a): tinyllama-1.1b at full width and 2 layers in f32
SHARDED_LAYERS, SHARDED_STEPS = 2, 3
#: phase 15 (b): all 22 layers in bf16 with remat on (2, 2), the first
#: steps of phase 14 (a)'s schedule (its 16 steps, halted); 2, not 4, for
#: the script's 1,200 s limit: on H100 hosts 4 steps took 93.4-137.3 s, 3
#: took 109.7 s and 2 took 49.0 s, and the whole script with 4 took up to
#: 1,136.5 s
SHARDED_FULL_STEPS = 2
#: phase 15 (c): qwen3-moe-30b-a3b at full width in f32 on a (1, 4) mesh
#: (128 experts over 'model' = 4: the expert-parallel path), 1 step of
#: batch 4 x 128 tokens, not 2, for the script's 1,200 s limit (on H100
#: hosts 2 steps took 84.5-86.5 s on the CPU and 6.9-10.6 s on the card,
#: 1 step 40.2-61.7 s and 5.8-8.5 s); depth cut to 1 of 48 layers: the
#: same sharded steps run on the CPU of the card's host, whose simulated
#: ranks took 119 s for 2 steps at 2 layers (AdamW over 1.84 G f32
#: parameters and their moments in host memory); and at 2 layers a token
#: whose 8th and 9th of 128 router probabilities tie within the two
#: devices' last-bit difference after a step takes another expert on one
#: of them (step 1's loss 1.0e-5 and gradient norm 1.6e-4 apart), past
#: the dense rule
SHARDED_MOE = ("qwen3-moe-30b-a3b", 1, (1, 4), 1)
#: phase 15 (d): 4 steps halted at 2 and resumed (the checkpoint every 2)
ELASTIC_STEPS, ELASTIC_HALT = 4, 2
#: phase 15 (e): decode steps of the sharded-trained model's head
SHARDED_SERVE_TOKENS = 8
#: phase 15 (f): the dry run's cells (host tracing); qwen3-moe-30b-a3b's
#: is the script's one bf16 FSDP train step
DRYRUN_CELLS = (("tinyllama-1.1b", "train_4k", "single"),
                ("qwen3-moe-30b-a3b", "train_4k", "single"),
                ("grok-1-314b", "decode_32k", "multi"))


def gathered(t: torch.Tensor) -> torch.Tensor:
    """A DTensor as one plain tensor on its device, the simulated ranks'
    copies reconciled (they must agree)."""
    if isinstance(t, torch.distributed.tensor.DTensor):
        t = t.full_tensor()
    if hasattr(t, "reconcile"):
        t = t.reconcile()
    return t.detach()


def trained_state(res) -> tuple:
    """``({name: parameter}, {mu/name, nu/name: moment}, losses)`` of a
    trainer run, gathered."""
    params = {n: gathered(p) for n, p in res["model"].named_parameters()}
    moments = {f"{k}/{n}": gathered(t) for k in ("mu", "nu")
               for n, t in getattr(res["opt"], k).items()}
    return params, moments, [h["loss"] for h in res["history"]]


def hold_params(got: dict, want: dict, lr: float, steps: int,
                what: str) -> dict:
    """`train_card_vs_cpu`'s rule over two parameter sets: all but 0.1 %
    within rtol 1e-4 and atol lr / 100, every one within 2 lr a step."""
    off = past_rtol = n = 0
    worst = 0.0
    for name, w in want.items():
        d = (got[name].float().cpu() - w.float().cpu()).abs()
        ref = CARD_CPU_RTOL * w.float().cpu().abs()
        worst = max(worst, float(d.max()))
        past_rtol += int((d > ref).sum())
        off += int((d > ref + 1e-2 * lr).sum())
        n += d.numel()
    check(worst <= 2 * lr * steps and off <= 1e-3 * n,
          f"{what}: {off} of {n} parameters past rtol {CARD_CPU_RTOL} and "
          f"atol lr / 100, largest gap {worst:.3g}")
    return {"params": n, "params_past_rtol_and_atol": off,
            "params_past_rtol_alone": past_rtol, "param_max_abs_err": worst}


def hold_losses(got, want, what: str, rtol: float = 1e-5) -> float:
    err = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    check(len(got) == len(want) and err <= rtol,
          f"{what}: losses {got} vs {want}")
    return err


@contextlib.contextmanager
def counted_steps():
    """Each `train_step` the trainer takes under a `TraceCounter`: its
    collectives (`collective_bytes`), one entry a step."""
    from repro_torch.launch import train as T
    from repro_torch.launch.comm_analysis import TraceCounter, \
        collective_bytes
    steps, real = [], T.train_step

    def counted(*a, **k):
        with TraceCounter() as tc:
            out = real(*a, **k)
        steps.append(collective_bytes(tc.collectives))
        return out
    T.train_step = counted
    try:
        yield steps
    finally:
        T.train_step = real


def sharded_card_vs_single() -> dict:
    """Phase 15 (a): `SHARDED_STEPS` trainer steps of tinyllama-1.1b at
    full width and `SHARDED_LAYERS` layers in f32 on each mesh of
    `SHARDED_MESHES` (ranks simulated on the card), against the single
    device step on the card from the same seeded weights and batches."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import simulated_mesh
    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              n_layers=SHARDED_LAYERS, dtype="float32")
    args = train_args("--steps", str(SHARDED_STEPS))
    single = T.train(args, cfg=cfg)
    want = {n: p.detach() for n, p in single["model"].named_parameters()}
    wl = [h["loss"] for h in single["history"]]
    wg = [h["grad_norm"] for h in single["history"]]
    out = {"layers": SHARDED_LAYERS, "steps": SHARDED_STEPS,
           "dtype": "float32", "single_losses": wl}
    del single
    for shape in SHARDED_MESHES:
        t0 = time.perf_counter()
        with simulated_mesh(shape, device=DEV) as mesh:
            res = T.train(args, cfg=cfg, mesh=mesh)
            got, _, losses = trained_state(res)
        gn = [h["grad_norm"] for h in res["history"]]
        what = f"train sharded {shape}"
        rec = {"losses": losses,
               "loss_rel_err": hold_losses(losses, wl, what),
               "grad_norm_rel_err": max(abs(a - b) / b
                                        for a, b in zip(gn, wg)),
               "ms_per_step_serialised": [s * 1e3 for s in res["step_s"]],
               "run_s": time.perf_counter() - t0}
        check(rec["grad_norm_rel_err"] <= CARD_CPU_RTOL,
              f"{what}: grad norms {gn} vs {wg}")
        rec.update(hold_params(got, want, args.lr, SHARDED_STEPS, what))
        out[str(shape)] = rec
        say(f"{what}: " + json.dumps(rec))
        del res, got
        torch.cuda.empty_cache()
    return out


#: phase 15 (b): how far its bf16 losses may stray from phase 14 (a)'s
#: (each rank rounds its part of a split product to bf16 before the
#: parts are added in f32 and rounded once more, where one card
#: accumulates the whole product in f32 and rounds once): measured at
#: most 1.14e-4 on an H100 80GB HBM3 at 700 W, held at about 9 times that
SHARDED_BF16_LOSS_RTOL = 1e-3


def sharded_full(phase14_losses) -> tuple:
    """Phase 15 (b): tinyllama-1.1b at full width and depth in bf16 with
    remat on a (2, 2) mesh simulated on the card, the first
    `SHARDED_FULL_STEPS` steps of phase 14 (a)'s run (its weights,
    batches and schedule: the trainer at ``--steps 16``, halted).
    Returns the trained model gathered into plain tensors (for (e)), its
    config and the record."""
    from repro_torch.distributed.specs import local_bytes
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import simulated_mesh
    args = train_args("--steps", str(TRAIN_STEPS))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with counted_steps() as steps, simulated_mesh((2, 2), device=DEV) \
            as mesh:
        res = T.train(args, mesh=mesh, halt_at=SHARDED_FULL_STEPS)
        cfg, model = res["cfg"], res["model"]
        hist, step_s = res["history"], res["step_s"]
        rec = {"param_gb_per_rank": local_bytes(model.parameters()) / 1e9,
               "moment_gb_per_rank": local_bytes(
                   [*res["opt"].mu.values(), *res["opt"].nu.values()])
               / 1e9}
        del res
        gc.collect()
        peak = torch.cuda.max_memory_allocated() / 1e9
        with torch.no_grad():
            for mod in model.modules():
                for n, p in list(mod.named_parameters(recurse=False)):
                    setattr(mod, n, torch.nn.Parameter(
                        gathered(p), requires_grad=True))
    losses = [h["loss"] for h in hist]
    check(cfg.n_layers == 22 and cfg.dtype == "bfloat16" and cfg.remat
          and len(losses) == SHARDED_FULL_STEPS
          and all(np.isfinite(losses)),
          f"train sharded full: {cfg.n_layers} layers in {cfg.dtype}, "
          f"losses {losses}")
    ref = phase14_losses[:SHARDED_FULL_STEPS]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
    check(max(rel) <= SHARDED_BF16_LOSS_RTOL,
          f"train sharded full: losses {losses} vs phase 14's {ref}")
    rec.update({
        "mesh": [2, 2], "layers": cfg.n_layers, "dtype": cfg.dtype,
        "remat": cfg.remat, "batch": args.batch, "seq": args.seq,
        "losses": losses, "phase14_losses": ref, "loss_rel_err": rel,
        "peak_card_gb": peak,
        "collectives_per_step": steps,
        "ms_per_step_four_ranks_serialised_on_one_card_not_a_throughput":
            [s * 1e3 for s in step_s],
        "run_s": time.perf_counter() - t0})
    say("train sharded full: " + json.dumps(rec))
    return model, cfg, rec


def sharded_serve(model, cfg) -> dict:
    """Phase 15 (e): the model trained in (b), gathered, in the decode
    demo (4 prompts of 16 tokens, `SHARDED_SERVE_TOKENS` greedy tokens,
    the bandit head after a 2-token warm-up): the launch counts are set
    to 0 just before and read just after; ``fused_cascade_batched
    [bf16]`` launches must equal the decode steps, each held against the
    plain version."""
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import serve
    serve.run_decode_demo(decode_args(TRAIN_ARCH, "boundedme", 2),
                          model=model)
    args = decode_args(TRAIN_ARCH, "boundedme", SHARDED_SERVE_TOKENS)
    kops.reset_launch_counts()
    with recording_heads() as calls:
        out_b = serve.run_decode_demo(args, model=model)
    counts = kops.launch_counts()
    launches = counts["fused_cascade_batched[bf16]"]
    check(launches == args.tokens == counts["fused_cascade_batched"]
          == len(calls),
          f"train sharded serve: {launches} fused_cascade_batched[bf16] "
          f"launches ({counts['fused_cascade_batched']} in all, "
          f"{len(calls)} head calls) for {args.tokens} decode steps")
    table = model.head_table
    check(out_b["cfg"].n_layers == cfg.n_layers and table is model.unembed,
          "train sharded serve: not the trained model's unembedding")
    held = hold_head_steps("sharded-trained tinyllama-1.1b", calls,
                           out_b["cfg"], table)
    out = {**held, "launches": launches, "tokens": args.tokens,
           "ms_per_token": out_b["ms_per_token"],
           "head": head_launch(calls, out_b["cfg"], table, widened=True)}
    say("train sharded serve: " + json.dumps(out))
    return out


def sharded_moe_card_vs_cpu() -> dict:
    """Phase 15 (c): qwen3-moe-30b-a3b at full width in f32 on a (1, 4)
    mesh, the expert-parallel MoE (`SHARDED_MOE`: the depth cut and its
    reason), the same sharded steps on the card and on the CPU from the
    same weights: losses to rtol 1e-5, gradient norms to rtol 1e-4,
    parameters by `train_card_vs_cpu`'s rule."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import LMStream
    from repro_torch.distributed.sharding import logical_mesh
    from repro_torch.distributed.specs import (batch_pspecs, param_pspecs,
                                               place_params, place_tree)
    from repro_torch.launch.mesh import simulated_mesh
    from repro_torch.models import layers as TL
    from repro_torch.models.model import build_model
    from repro_torch.models.steps import train_step
    from repro_torch.optim.adamw import AdamWConfig, init_opt
    arch, layers, shape, n_steps = SHARDED_MOE
    cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                              dtype="float32")
    host = build_model(cfg, seed=3, device="cpu")
    card = copy.deepcopy(host).to(DEV)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    stream = LMStream(cfg.vocab, batch=4, seq=128, seed=0)
    ep, real = [], TL._moe_ep
    TL._moe_ep = lambda *a: ep.append(1) or real(*a)
    runs = {}
    try:
        for name, model, dev in (("card", card, DEV), ("cpu", host, "cpu")):
            ep.clear()
            t0 = time.perf_counter()
            with simulated_mesh(shape, device=dev) as mesh, \
                    logical_mesh(mesh):
                place_params(model, param_pspecs(
                    cfg, dict(model.named_parameters()), mesh), mesh)
                opt = init_opt(dict(model.named_parameters()))
                losses, norms = [], []
                for step in range(n_steps):
                    b = {k: torch.from_numpy(v).to(dev)
                         for k, v in stream.batch_at(step).items()}
                    b = place_tree(b, batch_pspecs(mesh, 4, b), mesh)
                    _, opt, m = train_step(model, opt, b, cfg, opt_cfg)
                    losses.append(float(m["loss"]))
                    norms.append(float(m["grad_norm"]))
                del opt
                params = {n: gathered(p).cpu()
                          for n, p in model.named_parameters()}
            check(len(ep) >= layers * n_steps,
                  f"train sharded moe {name}: {len(ep)} expert-parallel "
                  f"MoE calls")
            runs[name] = (params, losses, norms,
                          time.perf_counter() - t0, len(ep))
            del model
            if name == "card":
                del card
                gc.collect()
                torch.cuda.empty_cache()
    finally:
        TL._moe_ep = real
    (pc, lc, nc, sc, ec), (pp, lp, npu, sp, _) = runs["card"], runs["cpu"]
    what = f"train sharded moe {shape}"
    rec = {"arch": arch, "layers": layers, "mesh": list(shape),
           "steps": n_steps, "dtype": "float32", "ep_calls": ec,
           "losses_card": lc, "losses_cpu": lp,
           "loss_rel_err": [abs(a - b) / abs(b) for a, b in zip(lc, lp)],
           "grad_norm_rel_err": [abs(a - b) / b for a, b in zip(nc, npu)],
           "card_s": sc, "cpu_s": sp}
    say(f"{what}: " + json.dumps(rec))
    hold_losses(lc, lp, what)
    check(max(rec["grad_norm_rel_err"]) <= CARD_CPU_RTOL,
          f"{what}: grad norms {nc} vs {npu}")
    rec.update(hold_params(pc, pp, opt_cfg.lr, n_steps, what))
    say(f"{what}: " + json.dumps(rec))
    del runs, pc, pp
    gc.collect()
    return rec


def sharded_elastic() -> dict:
    """Phase 15 (d): (a)'s config on a (2, 2) mesh for `ELASTIC_STEPS`
    steps, and halted at `ELASTIC_HALT` with a checkpoint (a temporary
    directory, removed after), under deterministic algorithms: restored
    onto (2, 2) the resume is bitwise (losses, parameters, moments);
    restored onto (1, 2) and one device (re-sharded from the file) and
    continued, within (a)'s rule."""
    import os
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import simulated_mesh
    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              n_layers=SHARDED_LAYERS, dtype="float32")
    steps = ["--steps", str(ELASTIC_STEPS)]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_elastic_")

    def ckpt(name):
        return ["--ckpt-dir", os.path.join(tmp, name), "--ckpt-every",
                str(ELASTIC_HALT)]
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    out = {"layers": SHARDED_LAYERS, "steps": ELASTIC_STEPS,
           "halted_at": ELASTIC_HALT, "saved_on": [2, 2]}
    try:
        with simulated_mesh((2, 2), device=DEV) as mesh:
            whole = trained_state(T.train(train_args(*steps), cfg=cfg,
                                          mesh=mesh))
            T.train(train_args(*steps, *ckpt("a")), cfg=cfg, mesh=mesh,
                    halt_at=ELASTIC_HALT)
            for other in ("b", "c"):
                shutil.copytree(os.path.join(tmp, "a"),
                                os.path.join(tmp, other))
            res = T.train(train_args(*steps, *ckpt("a")), cfg=cfg,
                          mesh=mesh)
            check(res["start"] == ELASTIC_HALT,
                  f"train elastic: resumed at {res['start']}")
            rest = trained_state(res)
            del res
        check(rest[2] == whole[2][ELASTIC_HALT:],
              f"train elastic: losses {rest[2]} vs {whole[2]}")
        diff = [n for i in (0, 1) for n in whole[i]
                if not torch.equal(rest[i][n], whole[i][n])]
        check(not diff, f"train elastic: the (2, 2) resume is not bitwise: "
                        f"{diff[:5]}")
        out["resume_2x2_bitwise"] = True
        out["tensors_bitwise"] = len(whole[0]) + len(whole[1])
        with simulated_mesh((1, 2), device=DEV) as mesh:
            on12 = trained_state(T.train(train_args(*steps, *ckpt("b")),
                                         cfg=cfg, mesh=mesh))
        on11 = trained_state(T.train(train_args(*steps, *ckpt("c")),
                                     cfg=cfg))
        lr = train_args().lr
        for got, label in ((on12, "(1, 2)"), (on11, "(1, 1)")):
            what = f"train elastic onto {label}"
            out[label] = {"losses": got[2],
                          "loss_rel_err": hold_losses(
                              got[2], whole[2][ELASTIC_HALT:], what),
                          **hold_params(got[0], whole[0], lr,
                                        ELASTIC_STEPS - ELASTIC_HALT, what)}
    finally:
        torch.use_deterministic_algorithms(False)
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env
        shutil.rmtree(tmp, ignore_errors=True)
    say("train elastic: " + json.dumps(out))
    torch.cuda.empty_cache()
    return out


def _dryrun_cell(src: str, cell) -> dict:
    """One dry-run cell's record (`repro_torch.launch.dryrun.run_cell`: a
    fake group of 256 or 512 ranks and fake tensors, on the host), in a
    worker process of `dryrun_pool`."""
    if src not in sys.path:
        sys.path.insert(0, src)
    torch.set_num_threads(1)
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch import dryrun as D
    arch, shape, mesh_name = cell
    return D.run_cell(get_config(arch), get_shape(shape), mesh_name,
                      save=False)


@contextlib.contextmanager
def dryrun_pool():
    """``{cell: future}`` of the dry-run cells of phases 15 (f) and 16
    (d), traced one after another in one worker process while the card
    runs phases 15 and 16 (the host tracing took 70-100 s of the
    script's time); the worker is stopped on exit."""
    import concurrent.futures
    import multiprocessing
    pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    try:
        yield {cell: pool.submit(_dryrun_cell, str(ROOT / "src"), cell)
               for cell in (*DRYRUN_CELLS, *MESH_DRYRUN_CELLS)}
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def sharded_dryrun(cells) -> dict:
    """Phase 15 (f): the dry run of `DRYRUN_CELLS` (their records from
    `dryrun_pool`'s ``cells``); each must come back ``ok`` with no
    all-reduce or reduce-scatter of a 16-bit shape; prints each device's
    GB."""
    out = {}
    for arch, shape, mesh_name in DRYRUN_CELLS:
        rec = cells[(arch, shape, mesh_name)].result()
        tag = f"{arch} x {shape} x {mesh_name}"
        check(rec["ok"], f"dry run {tag}: {rec.get('error')}")
        check(rec["reductions_16_bit"] == 0,
              f"dry run {tag}: {rec['reductions_16_bit']} 16-bit "
              f"reductions")
        c = rec["collectives"]
        out[tag] = {
            "n_devices": rec["n_devices"], "fsdp": rec["fsdp"],
            "flops_per_device": rec["flops"],
            **{f"{k}_gb_per_device": rec[f"{k}_bytes"] / 1e9
               for k in ("param", "moment", "batch", "cache")},
            "argument_gb_per_device": rec["argument_size_in_bytes"] / 1e9,
            "collective_gb_per_device": c["total_bytes"] / 1e9,
            "collective_counts": {k[:-6]: v for k, v in c.items()
                                  if k.endswith("_count") and v},
            "trace_s": rec["lower_s"]}
        say(f"dry run {tag}: " + json.dumps(out[tag]))
    return out


def phase_train_sharded(phase14_losses, cells) -> dict:
    """Phase 15: multi-card training with the ranks of each mesh simulated
    on the one card (``LocalTensorMode``), then the dry run."""
    t_phase = time.perf_counter()
    out = {"card_vs_single": sharded_card_vs_single()}
    model, cfg, out["full"] = sharded_full(phase14_losses)
    out["serve"] = sharded_serve(model, cfg)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    out["elastic"] = sharded_elastic()
    out["moe"] = sharded_moe_card_vs_cpu()
    torch.cuda.empty_cache()
    out["dryrun"] = sharded_dryrun(cells)
    out["seconds"] = time.perf_counter() - t_phase
    say(f"train sharded: phase in {out['seconds']:.1f} s")
    return out


#: phase 16 (b): the serve table's row shards over a (1, 4) mesh, its
#: ranks simulated on the one card, per tier: (tag, precision)
MESH_SERVE_SHAPE = (1, 4)
MESH_SERVE_TIERS = (("bf16", "fp32"), ("int8", "int8"))
#: phase 16 (c): command-r-35b at full width with the bandit head on a
#: simulated (2, 2) mesh, in bf16 cut to 4 of 40 layers (14.1 GB of
#: weights, over the four ranks half again, and the tile copies, beside
#: the one-card references; all 40 layers are 64.8 GB), and in f32 cut to
#: 2 layers (22.4 GB; 16.8 GB of f32 tile shards on the ranks)
MESH_ARCH, MESH_LAYERS, MESH_LAYERS_F32, MESH_SHAPE = (
    "command-r-35b", 4, 2, (2, 2))
#: (c): 4 prompts of 512 tokens into a cache of decode_32k's 32,768
#: positions, then greedy tokens
MESH_PROMPT, MESH_CACHE, MESH_TOKENS = 512, 32_768, 16
#: phase 16 (d): the dry run's cells, on the host; qwen1.5-0.5b's
#: all-gather bytes per device and step of the cell's dry run when decode
#: gathered the whole split cache at every step
MESH_DRYRUN_CELLS = (("command-r-35b", "decode_32k", "single"),
                     ("qwen3-moe-30b-a3b", "decode_32k", "multi"),
                     ("qwen1.5-0.5b", "decode_32k", "single"))
GATHERED_CACHE_QWEN_DECODE_ALL_GATHER = 25_769_805_312


class TileRows:
    """Row ``i`` of a tile-major table ``V4 (n_tiles, n_blocks, R, C)``,
    as `compare` indexes a table (its near-tie check reads a few rows)."""

    def __init__(self, V4: torch.Tensor):
        self.V4 = V4

    def __getitem__(self, i: int) -> torch.Tensor:
        R = self.V4.shape[2]
        return self.V4[i // R, :, i % R, :].reshape(-1)


@contextlib.contextmanager
def recorded_launches():
    """Every launch of the batched cascade through the operator, with its
    operands and outputs (under simulated ranks: once per rank, on the
    rank's own tensors)."""
    from repro_torch.kernels import ops as kops
    real, calls = kops.fused_cascade_batched_cuda, []

    def record(*args, **kw):
        out = real(*args, **kw)
        calls.append((args, kw, out))
        return out
    kops.fused_cascade_batched_cuda = record
    try:
        yield calls
    finally:
        kops.fused_cascade_batched_cuda = real


#: the held mesh launches' score atol, in units of the launch's largest
#: |score|: a shard returns k_out = K + 1 candidates, and the one past
#: its top K may be any row of the winner's final tile, near zero (2.6e-6
#: beside 1.1e-3 on command-r's head, measured on one H100), where the
#: f32 sums' rounding (the products' scale, not the result's) fails a
#: relative tolerance alone
MESH_SCORE_ATOL = SCORE_RTOL


def hold_launches(what: str, calls, *, bitwise: bool) -> dict:
    """Each recorded launch against the plain version on its operands
    (`compare`, scores also within `MESH_SCORE_ATOL`; the near-tie check
    reads the launch's own tile-major table, the queries its blocked
    operand)."""
    from repro_torch.kernels.ref import fused_cascade_batched_ref
    errs, ties = [0.0], 0
    for i, (args, kw, out) in enumerate(calls):
        ref = fused_cascade_batched_ref(*args, **kw)
        torch.cuda.synchronize()
        Qb = args[1]
        try:
            r = compare(TileRows(args[0]),
                        Qb.reshape(Qb.shape[0], -1).float(), out, ref,
                        what=f"{what} launch {i}", bitwise=bitwise,
                        atol_scale=MESH_SCORE_ATOL)
        except SmokeFailure as e:
            raise SmokeFailure(f"{e}; kernel {out[:2]}, plain {ref[:2]}, "
                               f"|Qb| {float(Qb.float().abs().max())}") \
                from None
        errs.append(r["max_abs_err"])
        ties += r["near_tie_queries"]
    return {"held": len(calls), "max_abs_err": max(errs),
            "near_tie_queries": ties}


def shard_launch_times(plan, args, kw) -> dict:
    """One rank's recorded launch timed alone (CUDA events) against its
    bound and its plain version; beside them ``torch.matmul`` +
    ``torch.topk`` over the shard's rows where the launch pulls a float
    table (its own rows, untiled)."""
    from repro_torch.core.schedule import PULL_BIT
    from repro_torch.kernels.fused_cascade import fused_cascade_batched_cuda
    from repro_torch.kernels.ref import fused_cascade_batched_ref
    V4, Qb = args[0], args[1]
    kw = {k: v for k, v in kw.items() if v is not None}
    n_tiles, n_blocks, R, C = V4.shape
    pulled = torch.zeros((n_tiles, n_blocks), dtype=torch.bool, device=DEV)
    fused_cascade_batched_ref(*args, pulled=pulled, **kw)
    n_pulls = int(((args[2].cpu() & PULL_BIT) != 0).sum()) * Qb.shape[0]
    out = {**kernel_bound(plan, args, kw, pulled, n_pulls),
           "shard_table": [n_tiles * R, plan.N], "library_ms": None,
           "kernel_ms": time_cuda(lambda: fused_cascade_batched_cuda(
               *args, **kw), 10, 2),
           "plain_ms": time_cuda(lambda: fused_cascade_batched_ref(
               *args, **kw), 3, 1)}
    if V4.dtype in (torch.float32, torch.bfloat16):
        rows = V4.permute(0, 2, 1, 3).reshape(n_tiles * R, n_blocks * C)
        Qt = Qb.reshape(Qb.shape[0], -1).to(V4.dtype)
        out["library_ms"] = time_cuda(
            lambda: torch.topk(rows @ Qt.T, plan.K, dim=0), 10, 2)
    return out


def mesh_op_bitwise() -> dict:
    """Phase 16 (a): one ``[bf16]`` launch through the registered operator
    (``torch.ops.repro_torch.fused_cascade_batched``) bitwise the direct
    launch on phase 3's operands: the serve table in bf16, row mode, the
    fp32 tier, B = 4, K = 4, eps = delta = 0.1, n_valid 151,936."""
    from repro_torch.configs import get_config
    from repro_torch.convert import make_serving_table
    from repro_torch.core.boundedme_torch import tile_table
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.fused_cascade import fused_cascade_batched_cuda
    from repro_torch.launch.engine import seeded_perm
    table, n_valid = make_serving_table(get_config("qwen1.5-0.5b"), 0, DEV)
    plan = tier_plan(table, n_valid, "fp32", "hoeffding", "row")
    V4 = tile_table(table, plan, DEV)
    Q = torch.from_numpy(np.random.default_rng(1234).normal(
        size=(B, plan.N)).astype(np.float32)).to(DEV)
    args, kw = cascade_operands(plan, V4, Q, seeded_perm(0, 0, plan.n_blocks))
    direct = fused_cascade_batched_cuda(*args, n_valid=n_valid, **kw)
    kops.reset_launch_counts()
    via = kops.fused_cascade_batched(*args, n_valid=n_valid, **kw)
    counts = kops.launch_counts()
    torch.cuda.synchronize()
    check(counts["fused_cascade_batched[bf16]"] == 1
          == counts["fused_cascade_batched"],
          f"mesh op: {counts['fused_cascade_batched']} launches through "
          f"the operator")
    check(len(via) == 2 and all(torch.equal(a, b)
                                for a, b in zip(direct, via)),
          "mesh op: the operator's launch is not bitwise the direct one")
    out = {"table": list(table.shape), "bitwise": True, "launches": 1}
    say("mesh op: " + json.dumps(out))
    return out


def mesh_serve() -> dict:
    """Phase 16 (b): `sharded_bounded_me_decode` over a simulated
    `MESH_SERVE_SHAPE` ``DeviceMesh`` on the serve table (153,600 x 1,024
    bf16, nothing cut), B = 4, K = 4, eps = delta = 0.1, per tier of
    `MESH_SERVE_TIERS`: ids, scores and gaps bitwise the serving-`Mesh`
    version at S = 4 under the same perm; the launch counts set to 0 just
    before the mesh run and read just after (one launch per rank), each
    launch held against its plain version; rank 0's launch timed."""
    from repro_torch.configs import get_config
    from repro_torch.convert import make_serving_table
    from repro_torch.core.mips import table_abs_max
    from repro_torch.distributed.sharding import (Mesh, make_shard_plan,
                                                  sharded_bounded_me_decode)
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.engine import seeded_perm
    from repro_torch.launch.mesh import simulated_mesh
    table, n_valid = make_serving_table(get_config("qwen1.5-0.5b"), 0, DEV)
    n, N = table.shape
    Q = torch.from_numpy(np.random.default_rng(1234).normal(
        size=(B, N)).astype(np.float32)).to(DEV)
    S = MESH_SERVE_SHAPE[1]
    out = {}
    for tag, precision in MESH_SERVE_TIERS:
        kw = dict(K=K, eps=EPS, delta=DELTA, precision=precision,
                  value_range=2.0 * table_abs_max(table))
        plan = make_shard_plan(n, N, S, **kw)[0]
        perm = seeded_perm(0, 1, plan.n_blocks)
        want = sharded_bounded_me_decode(table, Q, perm, mesh=Mesh(
            [DEV] * S), n_valid=n_valid, **kw)
        t0 = time.perf_counter()
        with simulated_mesh(MESH_SERVE_SHAPE, device=DEV) as mesh:
            kops.reset_launch_counts()
            with recorded_launches() as calls:
                got = sharded_bounded_me_decode(table, Q, perm, mesh=mesh,
                                                n_valid=n_valid, **kw)
            counts = kops.launch_counts()
            got = [gathered(g) for g in got]
        run_s = time.perf_counter() - t0
        launches = counts[f"fused_cascade_batched[{tag}]"]
        check(launches == S == counts["fused_cascade_batched"]
              == len(calls),
              f"mesh serve {tag}: {launches} launches "
              f"({counts['fused_cascade_batched']} in all) on {S} ranks")
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"mesh serve {tag}: not bitwise the serving Mesh version")
        held = hold_launches(f"mesh serve {tag}", calls,
                             bitwise=precision == "int8")
        args, lkw, _ = calls[0]
        rec = {"launches": launches, **held, "bitwise_serving_mesh": True,
               "ids": got[0].tolist(), "run_s": run_s,
               "shard": shard_launch_times(plan, args, lkw)}
        del calls, args, lkw
        out[tag] = rec
        say(f"mesh serve {tag}: " + json.dumps(rec))
        torch.cuda.empty_cache()
    return out


def mesh_decode(dtype: str, layers: int, strict: bool) -> dict:
    """Phase 16 (c): `MESH_ARCH` at full width, ``layers`` layers in
    ``dtype`` with the bandit head: `MESH_PROMPT`-token prompts of 4 into
    a `MESH_CACHE`-position cache, `MESH_TOKENS` greedy tokens.  First on
    one card: the bandit head over the serving `Mesh` at S = 2 (the
    mesh's shard plan) and the exact head; then the same weights placed
    by `param_pspecs` on a simulated `MESH_SHAPE` mesh, the cache split
    over 'kvseq', each bandit step under a `TraceCounter`.  Kernel 1
    launches (counted from 0 over the mesh's bandit decode) equal steps x
    ranks, each held; no all-gather carries the cache.  With ``strict``
    (f32) the mesh's tokens equal both one-card references; in bf16 each
    rank rounds its part of a split product to bf16 before the parts are
    added in f32 and rounded once more (two parts add exactly in f32),
    where one card rounds the whole product once: its hidden states
    stand about 1 % from one card's (measured on one H100), and a
    near-tie can pick another token there: its tokens must equal the
    exact head's on the same mesh, and their agreement with one card is
    reported."""
    from repro_torch.distributed.sharding import Mesh, logical_mesh
    from repro_torch.distributed.specs import (batch_pspecs, local_bytes,
                                               param_pspecs, place_params,
                                               place_tree)
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import serve
    from repro_torch.launch.comm_analysis import (TraceCounter,
                                                  collective_bytes,
                                                  shape_bytes)
    from repro_torch.launch.engine import seeded_perm
    from repro_torch.launch.mesh import simulated_mesh
    from repro_torch.models.model import build_model
    from repro_torch.models.steps import decode_step, prefill_step
    what = f"mesh decode {dtype}"
    cfg = dataclasses.replace(serve.decode_config(decode_args(
        MESH_ARCH, "boundedme", MESH_TOKENS, MESH_PROMPT)),
        n_layers=layers, dtype=dtype)
    cfg_e = dataclasses.replace(cfg, mips_mode="exact")
    tag = tier_tag("fp32", torch.empty(0, dtype=getattr(torch, dtype)))
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, seed=0, device=DEV)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, MESH_PROMPT))).to(DEV)
    n_blocks = -(-cfg.d_model // min(512, cfg.d_model))
    perms = [seeded_perm(0, i, n_blocks) for i in range(MESH_TOKENS)]

    def greedy(c, tok, mesh=None, steps=None, calls=None):
        """Prefill and `MESH_TOKENS` greedy steps: the tokens (B, T) on
        the host; each step's collectives into ``steps``."""
        _, caches = prefill_step(model, tok, MESH_CACHE)
        if steps is not None:
            kv = caches[0]["k"]
            check(any(p.is_shard(1) for p in kv.placements),
                  f"{what}: the cache is not split over its sequence "
                  f"({kv.placements})")
            out["cache_gb_per_rank"] = local_bytes(
                t for layer in caches for t in layer.values()) / 1e9
            out["layer_k_bytes_per_rank"] = local_bytes([kv])
            kops.reset_launch_counts()
        cur, toks = tok[:, -1:], []
        for i in range(MESH_TOKENS):
            ts = time.perf_counter()
            with TraceCounter() as tc:
                nxt, caches = decode_step(model, c, caches, cur,
                                          MESH_PROMPT + i, perm=perms[i],
                                          mesh=mesh)
            torch.cuda.synchronize()
            if steps is not None:
                step_s.append(time.perf_counter() - ts)
                steps.append(tc.collectives)
            toks.append(gathered(nxt))
            cur = nxt[:, None]
        return torch.stack(toks, 1).cpu()
    out = {"arch": MESH_ARCH, "layers": layers, "mesh": MESH_SHAPE,
           "dtype": dtype, "prompt_len": MESH_PROMPT,
           "cache_len": MESH_CACHE, "tokens": MESH_TOKENS}
    # the one-card head's hidden states (as it casts them), for step 0's
    # distance to the mesh's and the top two exact logits' gap
    from repro_torch.models import steps as model_steps
    from repro_torch.models.model import masked_logits
    hid_card, head_call = [], model_steps.ShardedMipsHead.__call__

    def recording(self, hid, perm):
        hid_card.append(hid.to(self.shards[0].dtype).float())
        return head_call(self, hid, perm)
    model_steps.ShardedMipsHead.__call__ = recording
    try:
        card = greedy(cfg, prompt, Mesh([DEV] * MESH_SHAPE[1]))
    finally:
        model_steps.ShardedMipsHead.__call__ = head_call
    top2 = torch.topk(masked_logits(cfg, model.head_table.detach(),
                                    hid_card[0]), 2, dim=-1).values
    out["one_card_step0_top2_logit_gap"] = (top2[:, 0]
                                            - top2[:, 1]).tolist()
    exact = greedy(cfg_e, prompt)
    model._sharded_head = None
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    steps, step_s = [], []
    with simulated_mesh(MESH_SHAPE, device=DEV) as mesh, \
            logical_mesh(mesh):
        place_params(model, param_pspecs(
            cfg, dict(model.named_parameters()), mesh), mesh)
        tok = place_tree({"tokens": prompt}, batch_pspecs(
            mesh, B, {"tokens": prompt}), mesh)["tokens"]
        with recorded_launches() as calls:
            got = greedy(cfg, tok, steps=steps)
        counts = kops.launch_counts()
        plan = model._mesh_head.plan
        out["param_gb_per_rank"] = local_bytes(model.parameters()) / 1e9
        run_s = time.perf_counter() - t0
        if not strict:
            model._mesh_head = None
            got_exact = greedy(cfg_e, tok)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del model
    gc.collect()
    torch.cuda.empty_cache()
    ranks = MESH_SHAPE[0] * MESH_SHAPE[1]
    launches = counts[f"fused_cascade_batched[{tag}]"]
    check(launches == MESH_TOKENS * ranks
          == counts["fused_cascade_batched"] == len(calls),
          f"{what}: {launches} [{tag}] launches "
          f"({counts['fused_cascade_batched']} in all) for "
          f"{MESH_TOKENS} steps on {ranks} ranks")
    # each rank's launch held on the tensors it ran on, outside the
    # simulated ranks (where a fresh tensor would be one per rank)
    held = hold_launches(what, calls, bitwise=False)
    head = shard_launch_times(plan, *calls[0][:2])
    # step 0's hidden states on the mesh, from the launches of the ranks
    # at 'model' coordinate 0 (rank order: 'data' outer), against one
    # card's: relative L2 per row
    per_data = MESH_SHAPE[1]
    hid_mesh = torch.cat([calls[r][0][1].reshape(
        calls[r][0][1].shape[0], -1)[:, :cfg.d_model]
        for r in range(0, len(calls[:ranks]), per_data)])
    out["step0_hidden_rel_l2"] = ((hid_mesh - hid_card[0]).norm(dim=-1)
                                  / hid_card[0].norm(dim=-1)).tolist()
    del calls, hid_card
    gathers = [shape_bytes(sh) for st in steps for k, sh in st
               if k == "all-gather"]
    check(max(gathers) < 0.1 * out["layer_k_bytes_per_rank"],
          f"{what}: an all-gather of {max(gathers)} bytes against "
          f"{out['layer_k_bytes_per_rank']} bytes of one layer's K on a "
          f"rank")
    if strict:
        check(torch.equal(got, card),
              f"{what}: tokens {got.tolist()} vs one card's "
              f"{card.tolist()}")
        check(torch.equal(got, exact),
              f"{what}: tokens {got.tolist()} vs exact decode's "
              f"{exact.tolist()}")
    else:
        check(torch.equal(got, got_exact),
              f"{what}: tokens {got.tolist()} vs the mesh's exact decode "
              f"{got_exact.tolist()}")
    out.update({
        "tag": tag, "equal_one_card_serving_mesh": torch.equal(got, card),
        "equal_one_card_exact": torch.equal(got, exact),
        "agreement_one_card": float((got == card).float().mean()),
        "rows_equal_one_card": (got == card).all(1).tolist(),
        "one_card_equal_exact": torch.equal(card, exact),
        "launches": launches, **held,
        "collectives_per_step": {k: v for k, v in collective_bytes(
            steps[-1]).items() if v},
        "largest_all_gather_bytes": max(gathers),
        "ms_per_token_four_ranks_serialised_on_one_card_not_a_"
        "throughput": [t * 1e3 for t in step_s],
        "peak_card_gb": peak, "mem_before_gb": base_gb, "head": head,
        "run_s": run_s})
    say(f"{what}: " + json.dumps(out))
    return out


#: phase 16 (e): `MESH_ARCH`'s bf16 MLP down projection at full width
#: over (batch, seq) = `MESH_ROW_TOKENS` on a simulated (1, 4) mesh
MESH_ROW_SHAPE, MESH_ROW_TOKENS = (1, 4), (4, 16)


def mesh_row_parallel() -> dict:
    """Phase 16 (e): `MESH_ARCH`'s MLP down projection in bf16 at full
    width, ``h (4, 16, d_ff) @ w_down (d_ff, d_model)`` from seeded
    draws, on a simulated `MESH_ROW_SHAPE` mesh through the model code's
    path: ``h`` on the logical 'ff' axis, ``w_down``'s rows on 'model',
    the product a partial sum over 'model' that `shard` reduces.  Gated:
    the result is bitwise bf16 of the f32 sum, in rank order, of the
    card's own per-rank parts (`sharding.redistribute`'s rule), and its
    all-reduce is f32; reported: the outputs where the bf16 rank-order
    sum (one rounding per add) differs from it."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import (PartitionSpec,
                                                  logical_mesh, shard,
                                                  spec_of)
    from repro_torch.distributed.specs import place_tree
    from repro_torch.launch.comm_analysis import (TraceCounter,
                                                  collective_bytes)
    from repro_torch.launch.mesh import simulated_mesh
    what = "mesh row-parallel"
    cfg = get_config(MESH_ARCH)
    gen = torch.Generator(device=DEV).manual_seed(0)
    h = torch.randn((*MESH_ROW_TOKENS, cfg.d_ff), generator=gen,
                    device=DEV).to(torch.bfloat16)
    w = (torch.randn((cfg.d_ff, cfg.d_model), generator=gen, device=DEV)
         / cfg.d_ff ** 0.5).to(torch.bfloat16)
    ranks = MESH_ROW_SHAPE[0] * MESH_ROW_SHAPE[1]
    with simulated_mesh(MESH_ROW_SHAPE, device=DEV) as mesh, \
            logical_mesh(mesh):
        placed = place_tree({"h": h, "w_down": w},
                            {"h": spec_of("batch", "seq", "ff"),
                             "w_down": PartitionSpec("model", None)}, mesh)
        part = placed["h"] @ placed["w_down"]
        check(any(p.is_partial() for p in part.placements),
              f"{what}: the product is not a partial sum "
              f"({part.placements})")
        local = part.to_local()
        parts = [local._local_tensors[r] for r in range(ranks)]
        with TraceCounter() as tc:
            y = shard(part, "batch", "seq", None)
        got = gathered(y)
    torch.cuda.synchronize()
    acc, chain = parts[0].float(), parts[0]
    for p in parts[1:]:
        acc, chain = acc + p.float(), chain + p
    want = acc.to(torch.bfloat16)
    reduces = [sh for k, sh in tc.collectives if k == "all-reduce"]
    check(got.dtype == torch.bfloat16 and torch.equal(got, want),
          f"{what}: {int((got != want).sum())} of {got.numel()} outputs "
          f"are not bf16 of the f32 sum of the ranks' parts")
    check(bool(reduces) and all(sh.startswith("f32[") for sh in reduces),
          f"{what}: all-reduces {reduces}")
    out = {"arch": MESH_ARCH, "h": list(h.shape), "w_down": list(w.shape),
           "mesh": MESH_ROW_SHAPE, "bitwise_f32_sum_rounded_once": True,
           "outputs": got.numel(),
           "outputs_apart_from_bf16_chain": int((chain != got).sum()),
           "max_abs_apart_from_bf16_chain": float(
               (chain.float() - got.float()).abs().max()),
           "collectives": {k: v for k, v in collective_bytes(
               tc.collectives).items() if v}}
    say(f"{what}: " + json.dumps(out))
    return out


def mesh_dryrun(cells) -> dict:
    """Phase 16 (d): `MESH_DRYRUN_CELLS` through the dry run on the host
    (their records from `dryrun_pool`'s ``cells``), each ``ok`` with no
    16-bit all-reduce or reduce-scatter; the bandit head's cells with
    ``mips_mode`` boundedme; the dense cell's all-gather bytes below its
    cache bytes and against those of decode that gathered the whole
    split cache."""
    from repro_torch.configs import get_config
    out = {}
    for arch, shape, mesh_name in MESH_DRYRUN_CELLS:
        cfg = get_config(arch)
        rec = cells[(arch, shape, mesh_name)].result()
        tag = f"{arch} x {shape} x {mesh_name}"
        check(rec["ok"], f"dry run {tag}: {rec.get('error')}")
        check(rec["reductions_16_bit"] == 0,
              f"dry run {tag}: {rec['reductions_16_bit']} 16-bit "
              f"reductions")
        check(rec["mips_mode"] == cfg.mips_mode,
              f"dry run {tag}: mips_mode {rec['mips_mode']}")
        c = rec["collectives"]
        check(c["all-gather_bytes"] < rec["cache_bytes"],
              f"dry run {tag}: {c['all-gather_bytes']} all-gather bytes "
              f"against {rec['cache_bytes']} of cache")
        out[tag] = {"mips_mode": rec["mips_mode"],
                    "all_gather_bytes": c["all-gather_bytes"],
                    "all_gather_count": c["all-gather_count"],
                    "all_reduce_bytes": c["all-reduce_bytes"],
                    "all_reduce_count": c["all-reduce_count"],
                    "cache_bytes": rec["cache_bytes"],
                    "trace_s": rec["lower_s"]}
        if arch == "qwen1.5-0.5b":
            out[tag]["gathered_cache_all_gather_bytes"] = (
                GATHERED_CACHE_QWEN_DECODE_ALL_GATHER)
        say(f"dry run {tag}: " + json.dumps(out[tag]))
    return out


def phase_mesh_decode(cells) -> dict:
    """Phase 16: decode over a mesh — kernel 1 through its operator, the
    sharded decode over a simulated ``DeviceMesh``, a model placed over
    one, a bf16 row-parallel product's reduction, and the dry run's
    bandit cells."""
    t_phase = time.perf_counter()
    out = {"op": mesh_op_bitwise()}
    torch.cuda.empty_cache()
    out["serve"] = mesh_serve()
    out["decode"] = mesh_decode("bfloat16", MESH_LAYERS, strict=False)
    out["decode_f32"] = mesh_decode("float32", MESH_LAYERS_F32,
                                    strict=True)
    out["row_parallel"] = mesh_row_parallel()
    torch.cuda.empty_cache()
    out["dryrun"] = mesh_dryrun(cells)
    out["seconds"] = time.perf_counter() - t_phase
    say(f"mesh decode: phase in {out['seconds']:.1f} s")
    return out


#: phase 17 (b): serve_decode_mips at its geometry (B = 8, P = 12) for
#: 30 tokens a head, 60 bandit steps over its two eps
EXAMPLE_DECODE_TOKENS = 30
#: what ``examples/frank_wolfe_lmo.py`` prints on the CPU (jax 0.9.0):
#: per LMO tag, the rel err and the LMO multiplies over naive
FRANK_WOLFE_JAX = {"exact": ("0.1556", "1.00"),
                   "boundedme(eps=0.2)": ("0.1556", "0.56"),
                   "boundedme(eps=0.5)": ("0.1556", "0.21")}
#: phase 17 (d): train_lm's --full run, and its 2-layer f32 twin held on
#: the card against the CPU first
EXAMPLE_TRAIN_STEPS, EXAMPLE_TWIN_LAYERS, EXAMPLE_TWIN_STEPS = 20, 2, 2
#: phase 17 (d): the chain sums of the ``D`` gradient held against the
#: plain version, those of step 0 (one a layer)
EXAMPLE_CHAINS_HELD = 24
#: phase 17 (e): (script, arguments, seconds allowed) as a user runs them
EXAMPLE_SCRIPTS = (("quickstart", (), 240), ("serve_decode_mips", (), 240),
                   ("frank_wolfe_lmo", (), 240),
                   ("train_lm", ("--full", "--steps", "10"), 300))


def example_decode() -> dict:
    """Phase 17 (b): ``examples_torch/serve_decode_mips.py``'s `run` at the
    example's config and batch, `EXAMPLE_DECODE_TOKENS` tokens a head
    (after a 2-token warm-up on the same model), the launch counts set to
    0 just before and read just after: one ``fused_cascade_batched[fp32]``
    launch per bandit step, each held against the plain version."""
    from repro_torch.kernels import ops as kops
    sd = load_example("serve_decode_mips")
    cfg = sd.make_config()
    warm = sd.run(cfg, T=2, device=DEV, log=lambda s: None)
    model = warm["model"]
    T = EXAMPLE_DECODE_TOKENS
    kops.reset_launch_counts()
    with recording_heads() as calls:
        res = sd.run(cfg, T=T, device=DEV, model=model,
                     log=lambda s: say("serve_decode_mips: " + s))
    counts = kops.launch_counts()
    launches = counts["fused_cascade_batched[fp32]"]
    bandit = [t for t in res["tokens"] if t != "exact"]
    check(launches == T * len(bandit) == counts["fused_cascade_batched"]
          == len(calls),
          f"serve_decode_mips: {launches} fused_cascade_batched[fp32] "
          f"launches ({counts['fused_cascade_batched']} in all, "
          f"{len(calls)} head calls) for {T * len(bandit)} bandit steps")
    table = model.head_table
    check(table.dtype == torch.float32 and table.shape[0]
          == res["padded_rows"] == cfg.padded_vocab,
          f"serve_decode_mips: head table {tuple(table.shape)} "
          f"{table.dtype}")
    held = hold_head_steps("serve_decode_mips", calls, cfg, table)
    out = {**held, "launches": launches, "batch": 8, "tokens": T,
           "padded_rows": res["padded_rows"],
           "token_agreement_with_exact": res["agreement"],
           "ms_per_token": {k: 1e3 * v / T
                            for k, v in res["seconds"].items()},
           "head": head_launch(calls, cfg, table, widened=False)}
    say("serve_decode_mips: " + json.dumps(out))
    del calls, model, warm, res
    gc.collect()
    torch.cuda.empty_cache()
    return out


def frank_wolfe_drift(fw, S, target, card: list) -> str:
    """Where the card's Frank-Wolfe run leaves the CPU's: per LMO, the
    first step whose pick differs and both arms' exact mean products at
    that step's query (the CPU trajectory's)."""
    notes = []
    n, N = S.shape
    S64 = torch.from_numpy(S).double()
    for lmo, eps in fw.LMOS:
        tag = lmo if eps is None else f"{lmo}(eps={eps})"
        want = []
        fw.frank_wolfe(S, target, iters=25, lmo=lmo, eps=eps or 0,
                       device="cpu", trace=want)
        got = next(r["trace"] for r in card if r["tag"] == tag)
        for (t, a, _), (_, c, _) in zip(got, want):
            if a != c:
                x, _ = fw.frank_wolfe(S, target, iters=t, lmo=lmo,
                                      eps=eps or 0, device="cpu")
                q = -2.0 * (x.double() - torch.from_numpy(target))
                m = S64 @ q / N
                notes.append(f"{tag} step {t}: card arm {a} (mean "
                             f"{float(m[a]):.9g}) vs CPU arm {c} (mean "
                             f"{float(m[c]):.9g})")
                break
    return "; ".join(notes) or "no pick differs from the CPU run"


def example_frank_wolfe() -> dict:
    """Phase 17 (c): ``examples_torch/frank_wolfe_lmo.py``'s `run` on the
    card at the script's size (n = 1000, N = 20,000, 25 iterations): its
    three lines, each held to the JAX example's printed rel err and
    multiplies; then one LMO call of each kind timed."""
    from repro_torch.core.boundedme import bounded_me, reward_matrix
    fw = load_example("frank_wolfe_lmo")
    S, target = fw.problem(1000, 20_000)
    t0 = time.perf_counter()
    runs = fw.run(S, target, iters=25, device=DEV,
                  log=lambda s: say("frank_wolfe_lmo: " + s))
    run_s = time.perf_counter() - t0
    bad = [r["tag"] for r in runs
           if (f"{r['rel_err']:.4f}", f"{r['multiplies']:.2f}")
           != FRANK_WOLFE_JAX[r["tag"]]]
    if bad:
        check(False, f"frank_wolfe_lmo: {bad} differ from the JAX example's "
              f"{FRANK_WOLFE_JAX}: " + frank_wolfe_drift(fw, S, target,
                                                          runs))
    Sc = torch.from_numpy(S).to(DEV)
    S64 = Sc.double()
    tc = torch.from_numpy(target).to(DEV)
    q = -2.0 * (Sc[0] - tc)
    vr = float(Sc.abs().max()) * float(q.abs().max())
    perm = np.random.default_rng(0).permutation(S.shape[1])

    def host_ms(fn, n: int = 5) -> float:
        fn()
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times)
    lmo_ms = {"exact": host_ms(lambda: int(torch.argmax(S64 @ q)))}
    for eps in (0.2, 0.5):
        lmo_ms[f"boundedme(eps={eps})"] = host_ms(lambda eps=eps: int(
            bounded_me(reward_matrix(Sc, q, perm=perm), K=1, eps=eps * vr,
                       delta=0.1, value_range=2 * vr).topk[0]))
    out = {"run_s": run_s, "lmo_ms": lmo_ms,
           "runs": {r["tag"]: {k: r[k] for k in ("rel_err", "multiplies",
                                                 "pulls", "seconds")}
                    for r in runs}}
    say("frank_wolfe_lmo: " + json.dumps(out))
    del Sc, S64
    torch.cuda.empty_cache()
    return out


def example_train_twin() -> dict:
    """Phase 17 (d), first: mamba2-130m at full width cut to
    `EXAMPLE_TWIN_LAYERS` layers in f32, `EXAMPLE_TWIN_STEPS` trainer
    steps at train_lm's flags on the card against the same steps on the
    CPU: losses to rtol 1e-5 (`hold_losses`), gradient norms to rtol
    1e-4, parameters by `hold_params` (`train_card_vs_cpu`'s rule)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as T
    tl = load_example("train_lm")
    cfg = dataclasses.replace(get_config("mamba2-130m"),
                              n_layers=EXAMPLE_TWIN_LAYERS, dtype="float32")
    res, real = {}, T.build_model

    def drawn_on_cpu(cfg, seed=0, device="cuda"):
        # one draw for both runs: a seeded draw differs by device
        return real(cfg, seed=seed, device="cpu").to(device)
    T.build_model = drawn_on_cpu
    try:
        for dev in ("cpu", DEV):
            argv = tl.command(tl.parse_args(
                ["--full", "--steps", str(EXAMPLE_TWIN_STEPS), "--device",
                 dev, "--ckpt-dir", ""]))
            t0 = time.perf_counter()
            res[dev] = T.train(T.parse_args(argv[3:]), cfg=cfg)
            res[dev]["run_s"] = time.perf_counter() - t0
    finally:
        T.build_model = real
    host, card = res["cpu"], res[DEV]
    lossh = [h["loss"] for h in host["history"]]
    lossc = [h["loss"] for h in card["history"]]
    gn = [(h["grad_norm"], c["grad_norm"])
          for h, c in zip(host["history"], card["history"])]
    what = "train_lm twin mamba2-130m card vs cpu"
    out = {"layers": EXAMPLE_TWIN_LAYERS, "steps": EXAMPLE_TWIN_STEPS,
           "dtype": "float32", "losses_card": lossc, "losses_cpu": lossh,
           "loss_rel_err": hold_losses(lossc, lossh, what),
           "grad_norm_rel_err": max(abs(c - h) / h for h, c in gn),
           "cpu_s": host["run_s"], "card_s": card["run_s"]}
    check(out["grad_norm_rel_err"] <= CARD_CPU_RTOL,
          f"{what}: grad norms {gn}")
    out.update(hold_params(
        {n: p.detach() for n, p in card["model"].named_parameters()},
        {n: p.detach() for n, p in host["model"].named_parameters()},
        card["opt_cfg"].lr, EXAMPLE_TWIN_STEPS, what))
    say(f"{what}: " + json.dumps(out))
    del res, host, card
    gc.collect()
    torch.cuda.empty_cache()
    return out


def example_train_full() -> dict:
    """Phase 17 (d): ``examples_torch/train_lm.py --full`` through the
    trainer in process, with the command line the example builds:
    mamba2-130m at its published size (24 layers, d_model 768, state
    128, vocab 50,280, bf16, remat), B = 8, S = 128, lr 3e-3,
    `EXAMPLE_TRAIN_STEPS` steps, the checkpoint in a temporary directory
    (removed after): finite losses, the last below the first.  The
    launch counts are set to 0 just before and read just after: each
    layer's bf16 ``D`` skip sums its gradient by the chain kernel in
    every step (`layers.scale_mul`), once a pass; the first
    `EXAMPLE_CHAINS_HELD` of those sums are held bitwise against the
    plain version on the same cotangents."""
    import shutil
    from repro_torch.kernels import chain_sum as cs
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import train as T
    from repro_torch.models import layers as L
    tl = load_example("train_lm")
    real_grad, calls, held = L._chain_grad, [], []

    def chain_grad(g, reduced):
        o = real_grad(g, reduced)
        calls.append(tuple(g.shape[d] for d in reduced))
        if len(held) < EXAMPLE_CHAINS_HELD:
            held.append((g.detach(), reduced, o.detach()))
        return o
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_lm_")
    argv = tl.command(tl.parse_args(
        ["--full", "--steps", str(EXAMPLE_TRAIN_STEPS), "--ckpt-dir", tmp,
         "--device", DEV]))
    say("train_lm --full: + " + " ".join(argv))
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    L._chain_grad = chain_grad
    try:
        with timed_checkpoints() as io:
            kops.reset_launch_counts()
            t0 = time.perf_counter()
            res = T.train(T.parse_args(argv[3:]))
            run_s = time.perf_counter() - t0
            launches = kops.launch_counts()["chain_sum"]
    finally:
        L._chain_grad = real_grad
        shutil.rmtree(tmp, ignore_errors=True)
    cfg, model, hist = res["cfg"], res["model"], res["history"]
    passes = sum(len(cs.passes(lead)) for lead in calls)
    check(len(calls) == cfg.n_layers * len(hist) and launches == passes
          and len(held) == EXAMPLE_CHAINS_HELD,
          f"train_lm --full: {launches} chain_sum launches, {len(calls)} "
          f"chain sums over {sorted(set(calls))} ({passes} passes) for "
          f"{cfg.n_layers} layers x {len(hist)} steps")
    apart = 0.0
    for g, reduced, o in held:
        want = plain_chain(g, reduced)
        apart = max(apart, chain_apart(o, want))
        check(torch.equal(o, want), f"train_lm --full: a D chain over "
              f"{tuple(g.shape)} dims {reduced} is not the plain version's")
    del held
    losses = [h["loss"] for h in hist]
    check(len(hist) == EXAMPLE_TRAIN_STEPS and all(np.isfinite(losses)),
          f"train_lm --full: losses {losses}")
    check(losses[-1] < losses[0],
          f"train_lm --full: the loss did not fall ({losses[0]:.4f} -> "
          f"{losses[-1]:.4f})")
    check((cfg.name, cfg.n_layers, cfg.d_model, cfg.ssm_state, cfg.vocab,
           cfg.dtype) == ("mamba2-130m", 24, 768, 128, 50_280, "bfloat16"),
          f"train_lm --full: not the published size: {cfg}")
    check([c[0] for c in io] == ["write"],
          f"train_lm --full: checkpoint calls {[c[0] for c in io]}")
    args = T.parse_args(argv[3:])
    tokens = args.batch * args.seq
    step_ms = statistics.median(res["step_s"][2:]) * 1e3
    out = {"arch": cfg.name, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "dtype": cfg.dtype, "remat": cfg.remat,
           "batch": args.batch, "seq": args.seq, "lr": args.lr,
           "steps": len(hist),
           "params": sum(p.numel() for p in model.parameters()),
           "losses": losses, "loss_fell_by": losses[0] - losses[-1],
           "grad_norms": [h["grad_norm"] for h in hist],
           "step0_ms": res["step_s"][0] * 1e3,
           "ms_per_step": step_ms,
           "ms_per_step_spread": [min(res["step_s"][2:]) * 1e3,
                                  max(res["step_s"][2:]) * 1e3],
           "tokens_per_s": tokens / step_ms * 1e3,
           "checkpoint": {"gb": io[0][2], "write_s": io[0][1]},
           "chain_sum": {"launches": launches, "sums": len(calls),
                         "leads": [list(d) for d in sorted(set(calls))],
                         "held": EXAMPLE_CHAINS_HELD, "max_abs_err": apart},
           "run_s": run_s, "mem_before_gb": base_gb,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    say("train_lm --full: " + json.dumps(out))
    del res, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def example_scripts() -> dict:
    """Phase 17 (e): each example as a user runs it, ``python
    examples_torch/<name>.py`` in a subprocess under a time limit (the
    kernels come from phase 2's build): exit code 0, its standard output
    printed here."""
    import os
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    try:
        for name, extra, limit in EXAMPLE_SCRIPTS:
            argv = [sys.executable, str(ROOT / "examples_torch" /
                                        f"{name}.py"), *extra]
            if name == "train_lm":
                argv += ["--ckpt-dir", tmp]
            t0 = time.perf_counter()
            proc = subprocess.run(argv, cwd=ROOT, env=env, text=True,
                                  capture_output=True, timeout=limit)
            seconds = time.perf_counter() - t0
            for line in proc.stdout.splitlines():
                say(f"{name}.py: {line}")
            check(proc.returncode == 0,
                  f"{name}.py exited {proc.returncode}: "
                  f"{proc.stderr[-2000:]}")
            out[name] = {"seconds": seconds, "returncode": proc.returncode}
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    say("example scripts: " + json.dumps(out))
    return out


def phase_examples(quickstart: dict) -> dict:
    """Phase 17: the port's examples on the card: (a) quickstart is phase
    9; (b) serve_decode_mips; (c) frank_wolfe_lmo; (d) train_lm --full,
    after its 2-layer f32 twin on the card against the CPU; (e) each
    script once as a user runs it."""
    t_phase = time.perf_counter()
    out = {"quickstart": quickstart, "decode": example_decode(),
           "frank_wolfe": example_frank_wolfe(),
           "train_twin": example_train_twin(),
           "train_full": example_train_full(),
           "scripts": example_scripts()}
    out["seconds"] = time.perf_counter() - t_phase
    say(f"examples: phase in {out['seconds']:.1f} s")
    return out


def kernel_entries(kern, single, aux, served, runtime, stored, tenancy,
                   lib, decode, sharded, families, trained,
                   trained_sharded, meshed, examples) -> list:
    """The ``kernels`` line: one entry per kernel and tier.  The batched
    cascade's launches are those of the serve, runtime, store, tenancy,
    decode, sharded, families, train, mesh decode and examples phases
    (the fp32 tier on the f32 stores, the sharded library call and the
    serve_decode_mips example's head; ``[bf16]`` on the bf16 serving
    table and model heads; S per sharded dispatch); its bf16 entry's
    times are the decode head's, on step 0's operands, and each family
    arch's head and the trained model's beside them.  The single-query
    cascade's launches are the library API's and quickstart's.  Times of
    a tier are phase 3's, row mode (coord beside them); the examples'
    kernel times ride in sub-entries.  The chain sum's launches are
    phase 14 (e)'s two steps' and phase 17 (d)'s (mamba2's ``D``; the
    subprocess of 17 (e) is not counted), its times phase 14 (e)'s at
    the step's shape and at the ``D`` shape, its ``max_abs_err`` the
    largest of every comparison with the plain version there."""
    none = {"launches": 0, "max_abs_err": 0.0}
    info = {t[0]: t[1:] for t in TIERS}
    info["bf16"] = info["fp32"]
    entries = []
    for tag in ["fp32", "bf16"] + [t[0] for t in TIERS[1:]]:
        precision, adaptive, bound = info[tag]
        runs = [served.get(tag, none), runtime.get(tag, none),
                stored["runtime"].get(tag, none),
                {"launches": tenancy["launches"].get(tag, 0),
                 "max_abs_err": tenancy["max_abs_err"].get(tag, 0.0)}]
        if tag == "bf16":
            runs += [decode["qwen1.5-0.5b"], decode["tinyllama-1.1b"]]
            runs += [families[arch] for arch, *_ in FAMILY_RUNS]
            runs.append(trained["serve"])
            runs.append(trained_sharded["serve"])
            runs.append(meshed["decode"])
        if tag == "fp32":
            runs.append(meshed["decode_f32"])
            runs.append(examples["decode"])
        runs.append(meshed["serve"].get(tag, none))
        runs.append(sharded["per_tag"].get(tag, none))
        row, coord = kern[(tag, "row")], kern.get((tag, "coord"))
        timed = decode["head"] if tag == "bf16" else row
        entry = {
            "name": "fused_cascade_batched" + (
                "" if tag == "fp32" else f"[{tag}]"),
            "route": "cuda", "source": SOURCE, "replaces": TPU_KERNEL,
            "launches": sum(r["launches"] for r in runs),
            "max_abs_err": max([row["max_abs_err"], timed["max_abs_err"]]
                               + [r["max_abs_err"] for r in runs]
                               + ([coord["max_abs_err"]] if coord else [])),
            "ms": timed["kernel_ms"], "plain_ms": timed["plain_ms"],
            "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
            "library_ms": timed["library_ms"],
            "precision": precision, "adaptive": adaptive, "bound": bound,
            "held_against_plain": True}
        if "grid_ctas" in row:
            entry["grid_ctas"] = row["grid_ctas"]
        if tag == "bf16":
            entry.update(serve_ms=row["kernel_ms"],
                         serve_bound_ms=row["bound_ms"])
            entry["families"] = {
                arch: {k: families[arch]["head"][k] for k in (
                    "table", "kernel_ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms")}
                | {"launches": families[arch]["launches"]}
                for arch, *_ in FAMILY_RUNS}
            head = trained["serve"]["head"]
            entry["trained"] = {
                k: head[k] for k in ("table", "kernel_ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")
            } | {"launches": trained["serve"]["launches"]}
            head = trained_sharded["serve"]["head"]
            entry["trained_sharded"] = {
                k: head[k] for k in ("table", "kernel_ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")
            } | {"launches": trained_sharded["serve"]["launches"]}
            head = meshed["decode"]["head"]
            entry["mesh_decode_shard"] = {
                k: head[k] for k in ("shard_table", "kernel_ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")
            } | {"launches": meshed["decode"]["launches"]}
        if tag == "fp32":
            head = examples["decode"]["head"]
            entry["serve_decode_mips"] = {
                k: head[k] for k in ("table", "kernel_ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")
            } | {"launches": examples["decode"]["launches"], "batch": 8}
        if tag in meshed["serve"]:
            head = meshed["serve"][tag]["shard"]
            entry["mesh_serve_shard"] = {
                k: head[k] for k in ("shard_table", "kernel_ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")
            } | {"launches": meshed["serve"][tag]["launches"]}
        if coord:
            entry.update(coord_ms=coord["kernel_ms"],
                         coord_plain_ms=coord["plain_ms"],
                         coord_bound_ms=coord["bound_ms"])
        entries.append(entry)
        if tag == "bf16":      # the single-query entry's bf16 time rides
            continue           # on its fp32 entry: no path launches it
        row1 = single[(tag, "row")]
        quick = examples["quickstart"] if tag == "fp32" else none
        entry = {
            "name": "fused_cascade" + ("" if tag == "fp32" else f"[{tag}]"),
            "route": "cuda", "source": SOURCE, "replaces": TPU_KERNEL_SINGLE,
            "launches": lib[(tag, "row")]["launches"]
            + lib[(tag, "coord")]["launches"] + quick["launches"],
            "max_abs_err": max(row1["max_abs_err"], quick["max_abs_err"], *(
                single[k]["max_abs_err"] for k in single if k[0] == tag)),
            "ms": row1["kernel_ms"], "plain_ms": row1["plain_ms"],
            "bound_ms": row1["bound_ms"], "bound_by": row1["bound_by"],
            "library_ms": row1["library_ms"], "grid_ctas": row1["grid_ctas"],
            "precision": precision, "adaptive": adaptive, "bound": bound,
            "held_against_plain": True}
        if (tag, "coord") in single:
            entry["coord_ms"] = single[(tag, "coord")]["kernel_ms"]
        if tag == "fp32":
            entry.update(bf16_ms=single[("bf16", "row")]["kernel_ms"],
                         bf16_coord_ms=single[("bf16", "coord")]["kernel_ms"])
            entry["quickstart"] = {
                f"{m}*sigma": {k: quick[m][k] for k in (
                    "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "call_ms")}
                for m in (0.5, 2.0, 8.0)} | {"launches": quick["launches"],
                                             "table": list(MF_SHAPE)}
        entries.append(entry)
    f32, b16 = torch.float32, torch.bfloat16
    for name, src, replaces, launches, base, alt in (
            ("gather_block_dot", "gather_dot.cu", TPU_GATHER,
             lib["gather_launches"], ("gather_block_dot", "row", f32),
             {"coord": ("gather_block_dot", "coord", f32),
              "bf16": ("gather_block_dot", "row", b16),
              "coord_bf16": ("gather_block_dot", "coord", b16)}),
            ("blocked_matvec", "blocked_matvec.cu", TPU_MATVEC,
             lib["matvec_launches"], ("blocked_matvec", f32),
             {"bf16": ("blocked_matvec", b16)})):
        r = aux[base]
        entry = {"name": name, "route": "cuda", "source": CSRC + src,
                 "replaces": replaces, "launches": launches,
                 "max_abs_err": max(aux[k]["max_abs_err"]
                                    for k in [base, *alt.values()]),
                 "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                 "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                 "library_ms": r["library_ms"], "shape": r["shape"],
                 "share_of_bound": r["share_of_bound"],
                 "grid_ctas": r["grid_ctas"], "branch": r["branch"],
                 "held_against_plain": True}
        if "against_matmul" in r:
            entry["against_matmul"] = {
                k: v for k, v in r["against_matmul"].items()
                if not k.endswith("_ms")
                or k.endswith(("median_ms", "spread_ms"))}
        for tag, key in alt.items():
            entry.update({f"{tag}_ms": aux[key]["kernel_ms"],
                          f"{tag}_plain_ms": aux[key]["plain_ms"],
                          f"{tag}_bound_ms": aux[key]["bound_ms"],
                          f"{tag}_library_ms": aux[key]["library_ms"],
                          f"{tag}_share_of_bound":
                              aux[key]["share_of_bound"]})
        entries.append(entry)
    bias = trained["bias_chain"]
    k, d = bias["kernel"], examples["train_full"]["chain_sum"]
    entries.append({
        "name": "chain_sum", "route": "cuda", "source": CSRC + "chain_sum.cu",
        "replaces": NOT_TPU_CHAIN,
        "launches": bias["launches"] + d["launches"],
        "max_abs_err": max(bias["max_abs_err"], d["max_abs_err"]),
        "ms": k["ms"], "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
        "library_ms": k["library_ms"], "shape": k["shape"],
        "passes": k["passes"], "bias_launches": bias["launches"],
        "mamba2_D": {key: k["mamba2_D"][key] for key in (
            "shape", "passes", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")} | {"launches": d["launches"]},
        "held_against_plain": True})
    return entries


def main() -> int:
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run this "
              f"script from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    try:
        t0 = time.perf_counter()
        phase_device()
        logs = phase_build()
        from repro_torch.configs import get_config
        from repro_torch.convert import make_serving_table
        # the vocab table in bf16, as the JAX package serves a bf16 model's
        # tied embedding; the store and the library API take it widened
        table, n_valid = make_serving_table(get_config("qwen1.5-0.5b"), 0,
                                            DEV)
        table32 = table.float()
        kern, single = phase_kernel(table, table32, n_valid)
        aux = phase_aux_kernels(table32, logs)
        served = {}
        for tier in TIERS:
            served[tier_tag(tier[0], table)] = serve_run(*tier)
            torch.cuda.empty_cache()
        runtime = {}
        for tier in RUNTIME_TIERS:
            runtime[tier_tag(tier[0], table)] = runtime_run(*tier)
            torch.cuda.empty_cache()
        stored = phase_store(table32, n_valid, runtime)
        tenancy = phase_tenancy()
        torch.cuda.empty_cache()
        lib = phase_mips(table32, n_valid)
        del table, table32
        torch.cuda.empty_cache()
        quick = phase_quickstart()
        torch.cuda.empty_cache()
        decode = phase_decode()
        torch.cuda.empty_cache()
        table, n_valid = make_serving_table(get_config("qwen1.5-0.5b"), 0,
                                            DEV)
        sharded = phase_sharded(table, n_valid, served, kern)
        del table
        torch.cuda.empty_cache()
        phase_paper()
        torch.cuda.empty_cache()
        families = phase_families()
        trained = phase_train()
        with dryrun_pool() as cells:
            trained_sharded = phase_train_sharded(trained["full"]["losses"],
                                                  cells)
            gc.collect()
            torch.cuda.empty_cache()
            meshed = phase_mesh_decode(cells)
        gc.collect()
        torch.cuda.empty_cache()
        examples = phase_examples(quick)
        say(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernel_entries(
        kern, single, aux, served, runtime, stored, tenancy, lib, decode,
        sharded, families, trained, trained_sharded, meshed, examples)}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
