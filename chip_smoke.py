#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--phases 9,16,21,24]

``--phases`` runs only the listed phases and those they need (phase 1
always runs); with no argument every phase runs.

Phases (each raises on failure; the script then exits non-zero):

1. device and build — needs ``torch.cuda.is_available()``; prints the card's
   name and power limit (``nvidia-smi``), builds every kernel of the
   port from ``src/repro_torch/csrc`` (nvcc, all sources in parallel),
   holds the design constants the CPU tests emulate (K2's split count,
   page and group limits, K4's heads per CTA) equal to the libraries' own,
   prints ptxas's registers and spills per kernel instantiation, counts
   K3's and K4's tensor-core instructions (``HGMMA`` in ``cuobjdump
   -sass``; none in either, or in any of K3's head-dim instantiations,
   fails the run) and K1's, K5's, K6's and K7's bulk copies (``UBLKCP``;
   none fails the run), and holds K1's design constants
   (``fused_dispatch.constants``) equal to the library's.
2. K1, the fused command drain, against its plain version at the serving
   pool shapes (four bf16 pools ``(28, nblk, 64, 8, 128)`` and the staging
   ring): every opcode, NOP padding, non-adjacent write-after-read pairs
   (three waves) and a staging role vector; bitwise equality, card,
   device-only and plain ms beside the byte bound, the wrapper's host ms
   in stages (checks, the library's plan, the whole call) and a profile
   of one call (one launch, no host-to-device copy, no pinned
   allocation).  Then the library's plan (``rc_fused_plan``) against the
   Python statement (``plan_moves``, ``chunking``) on 1,000 seeded random
   tables of at most 512 rows (WAR pairs and chains across plain,
   cross-pool, bitwise and staging rows, packed and in-place bitwise
   sources, RAW / WAW tables refused with the Python message, int32 and
   int64, every tenth on a grid of one CTA), each drained by the kernel
   over small pools against the plain version, bitwise; a 512-row table at
   full width (its moves through the device buffer); unaligned pages at
   float32 / bfloat16 / int32 and a base 4 bytes off (the word loop); and a
   table of NOPs only (no launch).
3. K2, paged decode attention, against its plain version at B=8, H=24,
   KVH=8, D=128, page=64, with CoW-shared blocks and an empty slot, on
   three slabs (``K2_LAYOUTS``: the serving layout, one sequence over 64
   visible pages, one page per sequence); card and device-only times.
   The bound counts the K/V slots some reader needs (a shared block once).
4. K3, prefill attention, against its plain version at B=1, H=24, KVH=8,
   D=128, causal, S=512 and a ragged S=250, on the (B, S, H, D) views the
   model passes, and at the edge cases ``K3_EDGES`` (S=1, S=65, a prefix
   of 100, non-causal); card and device-only times; SDPA is timed beside
   it as a yardstick only (the port never calls it).
5. serve llama3.2-3b at full width (28 layers, d_model 3072, bf16, random
   weights from seed 0; ``phase_decoder_serve``): admit 4 prompts, run one
   round, fork the first sequence into 2, run 15 more rounds.  Checks the
   launch counts of every kernel on that run, finite logits, and the first
   round's logits against the same admissions and round run through the
   plain versions on the card, then every K2 / K3 call of the admissions
   and the first round against its plain version (``tapped``); profiles
   three steady rounds and the four admissions into a fresh engine.
6. K5a (FPM copy), K5b (pool-to-pool copy) and K6 (BuZ zero-init).  First
   the library's host schedule (``rc_block_plan``) against the Python
   statement of it (``_live_pairs``, ``pair_waves``, ``launch_rows``,
   ``chunking``) on 1,000 seeded random tables of at most 264 rows (WAR
   chains, padding, sources out of range, RAW / WAW pairs, int32 and int64
   ids), each also run through the kernels over a small pool against the
   plain versions, bitwise, or refused with the Python message; the design
   constants against the library's.  Then, bitwise at full width: flat
   pools of 14,336 llama3.2-3b K/V pages ``(14336, 64, 8, 128)`` bf16 and
   phase 2's layer-stacked ``(28, 512, 64, 8, 128)``, m = 8 and 256 blocks
   per call with ``-1`` padding and an in-call write-after-read pair, WAR
   chains of depth 4 (in one pool, and K5b on one tensor), a call of 1,000
   rows (above the launch parameters' room), and unaligned pages at
   float32 / bfloat16 / int32 plus a base 4 bytes off (the word loop); one
   launch per call.  Kernel, device-only, plain and library-call times
   beside the byte bound; K5a's host work per call in stages (checks, the
   library's schedule, ``block_move``, the whole wrapper); a profile of one
   K5a and one K6 call (no host-to-device copy, no pinned allocation).
7. the fused drain against the per-mechanism fan-out: one fixed op script
   (``launch/mechanisms.py ab_program``: every mechanism, 419 rows) through
   two engines over identical full-width flat pools; pools bitwise equal, 1
   launch per flush fused and ``AB_FANOUT_LAUNCHES`` fanned out (the count
   the CPU tests pin against the JAX engine); ms per flush of each, the
   fused flush's card ms, K1's device ms and bound, its host ms in stages
   (``space_war_rows``, the table and ``_touched_pools``,
   ``ops.fused_dispatch``, the whole ``_drain_rows``) and K1's wrapper
   stages on its table.  The fan-out run is K5a's, K5b's and K6's main
   path, the fused run K1's: their launch counts are read around each.
8. Table 1 (``launch/mechanisms.py run``) on a phase-6 pool, m = 8 and 256,
   and Fig. 2 (``launch/applications.py run``) at llama3.2-3b full width
   with phase 5's weights, RowClone off and on (a main path of K1: its
   launches are counted); its ``checkpoint`` application trains yi-6b
   reduced for 12 steps with a checkpoint every 3, blocking and async.
9. K4, the SSD intra-chunk term, against its plain version with bf16 x / B
   / C and fp32 dt / cum as the models pass them: 8 chunk rows of Q = 256
   at mamba2-780m's (H = 48, N = 128) and zamba2-2.7b's (H = 80, N = 64)
   widths, and ragged single chunks of Q = 250 and 96; max |diff| <=
   ``K4_RTOL`` x max |plain|; kernel, device-only and plain times beside
   the bound; and the edge cases ``K4_EDGES`` (H = 5 and 3, N = 32 and
   256, Q = 96 and 250, fp32 inputs).  Then K2 (B = 4, H = KVH = 32) and K3 (H = KVH = 32; B = 4 at
   S = 384, phase 11's batch prefill, and B = 1 at S = 250 and 512) at
   zamba2's head dim 80, and K2 (B = 8) and K3 (S = 512 and 250) at head
   dim 128 with the head groups of the configs phases 12-13 serve: 32
   heads over 4 KV heads (yi-6b, group 8) and 16 over 16 (deepseek-moe-16b).
   Then K2 (B = 8, the three slabs) and K3 (``K3_CASES_256``: phase 14's
   batch prefill, S = 512 and a ragged 313 with the 256-patch prefix and
   without, at B = 1 and 4, the first five timed; ``K3_EDGES_256``: S = 1
   and 65) at paligemma-3b's head dim 256 with 8 heads over 1 KV head;
   SDPA beside K3 as a yardstick (with the prefix as a boolean mask).
   Then K2 (B = 4 and 8, the three slabs) and K3 (``K3_CASES_64``: causal
   S = 512 and a ragged 57, non-causal Sq = Skv = 128 and 14, non-causal
   Sq = 512 over Skv = 128 and 57 over 14, one query over 128, and the
   edges Skv = 1 and 65 over 200) at seamless-m4t-medium's head dim 64
   with 16 heads over 16 KV heads.
10. mamba2-780m at full width (48 layers, bf16, random weights from seed
    0) through ``LanguageModel.prefill_state`` / ``decode_state``: prefill
    4 prompts of 384 tokens (2 chunks) and one of 250 (one ragged chunk),
    then 16 greedy decode steps on the 4.  Checks K4 == 48 launches per
    prefill, finite logits, and the prefill and first-step logits against
    the same calls through the plain versions; prints prefill ms, ms per
    step, tokens/s and the state bytes, and a profile of a decode step and
    a prefill.
11. zamba2-2.7b at full width (54 Mamba2 layers, 9 shared-attention calls),
    the same protocol: K4 == 54 and K3 == 9 per prefill, K2 == 9 per step.
    In both phases every K4 (and K2 / K3) call of the two prefills and the
    first step is then held against its plain version on the same inputs,
    and for zamba2 four planted K2 / K3 faults (``hybrid_faults``) must
    each fail that per-call check; their effect on the logits is printed
    beside it.

12. deepseek-moe-16b at full width and depth (28 layers, 64 experts top-6
    with 2 shared, 16 heads over 16 KV heads, 33.8 GB of bf16 random
    weights from seed 0) through ``ServingEngine``, phase 5's protocol and
    function:
    K1 <= 1 launch per round (1 in a round with bulk work), K2 == 28 per
    round, K3 == 28 per admission, the allocated parameters against
    ``param_count()``, finite logits, the first round's logits against the
    same admissions and round through the plain versions (fed the same
    round-1 tokens) with the routing flips between the two runs counted
    (``models/moe.py RouteLog``; if the logits differ with flips, the
    plain run replays
    the kernel run's routing), then every K2 / K3 call of the admissions
    and the first round against its plain version on the same inputs
    (``tapped``).  Prints admission ms, ms per round, tokens/s and the
    profiles of steady rounds and of the admissions, each split into K2,
    K3, the expert products, the routing, the other device time and the
    host gap.
13. the same checks, on a short protocol (prompts of 250 and 512 tokens,
    a fork, 4 rounds), for yi-6b and mistral-nemo-12b at full depth,
    qwen2-72b cut to 16 of 80 layers with its QKV biases drawn nonzero from
    the seed, and phi3.5-moe-42b-a6.6b cut to 8 of 32 layers
    (``OTHER_CONFIGS``); each model is freed before the next is built.

14. paligemma-3b (vlm) at full width and depth (18 layers, 8 heads over 1
    KV head x 256, the 257,280-wide tied head; random bf16 weights from
    seed 0, patch embeddings N(0, 1) x 0.02 from the seed) through
    ``LanguageModel.prefill_state`` / ``decode_state`` (``phase_vlm``):
    prefill 4 x (256 patches + 128 tokens) and one 256 + 57, then 16
    greedy decode steps on the 4.  Checks K3 == 18 launches per prefill,
    K2 == 18 per step, the allocated parameters against
    ``param_count()``, finite logits, the prefill and first-step logits
    against the plain versions, and every K2 / K3 call of the two
    prefills and the first step against its plain version (``tapped``);
    prints prefill ms, ms per step, tokens/s, the state bytes, and the
    profiles of a step and a prefill split into K2, K3, the GEMMs, the
    other device time and the host gap.

15. (run right after phase 5, on its weights) the remaining
    ``ServingEngine`` features on llama3.2-3b at full width and depth
    (``phase_serving_features``): 4 prompts of 512 tokens sharing a
    384-token prefix, one engine at a time.  (a) ``dedup_admit``: 18 pages
    shared by 3 admissions, 14 resident blocks against 32, tokens
    identical to the dedup-off run's; (b) ``demote`` of the third
    sequence before round 3 and ``resume`` before round 5 over 64 spill
    slots: parked and resumed blocks bitwise equal to their sources,
    tokens identical to the unpreempted run's, the rows in the round's
    one K1 launch (card ms and bound printed); (c) an 8-slot
    double-buffered ring: a 16-page burst in one K1 launch, one shrink
    after a window without admission, one regrow with no flush of its
    own; (d) ``fused_staging=False``: tokens and K/V pools bitwise equal
    to the fused leg's, ``legacy_stage`` events and no K1 launch,
    admission card ms of both legs.  K1 <= 1 launch a round throughout.

16. seamless-m4t-medium (encdec) at full width and depth (12 encoder and
    12 decoder layers, d_model 1024, 16 heads over 16 KV heads x 64, the
    256,256-wide untied head; random bf16 weights from seed 0, source
    frames N(0, 1) x 0.02 from the seed) through
    ``LanguageModel.prefill_state`` / ``decode_state`` (``phase_encdec``):
    prefill 4 x 512 tokens over 128 frames and 1 x 57 over 14, then 16
    greedy decode steps on the 4.  Checks K3 == 36 launches per prefill
    (12 encoder, 12 causal, 12 cross), K2 == 12 and K3 == 12 per step,
    the allocated parameters against ``param_count()``, finite logits, the
    prefill and first-step logits against the plain versions, and every
    K2 / K3 call of the two prefills and the first step against its plain
    version (``tapped``); prints prefill ms, ms per step, tokens/s, the
    state bytes and the profiles of a step and a prefill.  Then
    (``phase_admission``) ``ServingEngine`` admits two seamless prompts
    (250 and 512 tokens, over zero source frames) and, after seamless is
    freed, two zamba2-2.7b prompts at full width: the promoted blocks
    bitwise equal to the facade's prefill of the same prompt, ``_extras``
    bitwise equal to its state, one K1 launch in the round, no K1 at
    admission, ``decode_round`` refused, and after ``free`` the allocator
    and ``_extras`` back where they started.

17. (run after phase 8, on phase 5's weights) the traffic layer
    (``phase_traffic``; ``launch/scheduler.py`` ``RequestScheduler`` and
    ``launch/multitenant.py``) on llama3.2-3b at full width and depth.
    (a) ``run_traffic`` with poisson and bursty arrivals (32 rounds, seed
    0) over the reference's undersized engine (4 slots x 8 blocks over 2
    slabs, 235 MB of K/V pools, an 8-slot double-buffered ring, 8 spill
    slots): <= 1 K1 launch every round, equal to the ``RoundReport``'s;
    every request done with its tokens; the bursty leg preempts and
    resumes; allocator, batch slots, ring and spill slots reclaimed; the
    schedule fields of every report equal to a CPU replay of the recorded
    arrival script on the reduced config; ms per round, launches per
    round, per-tenant token latency, TTFT and goodput; a profile of churn
    rounds split into K1, K2, K3, GEMMs, other, host gap and idle share,
    and one churn round's K2 / K3 calls against their plain versions.
    (b) the preemption parity script: a 2-slot engine that preempts
    against its same-batch twin without spill slots, tokens bitwise equal,
    the gold waiter admitted one round after the demotion, parked and
    resumed blocks bitwise equal to their sources, the tight run's K2 / K3
    calls against their plain versions; an 8-slot engine's agreement
    printed (first differing token and its top-2 margin).  (c) cancel of
    a queued, a running and a parked request.  (d) ``run_dedup`` on
    llama3.2-3b, then ``multitenant.run()`` (Fig. 3/4: the 1 / 2 / 3-copy
    mixes, RowClone off and on) on yi-6b at full width and depth (12.1 GB
    of random weights, a 2,048-block engine), and one mix leg's K2 / K3
    calls against their plain versions.

18. (run after phase 17, on phase 5's weights) the recovery path
    (``phase_recovery``; ``core/journal.py`` replay, ``RowCloneEngine
    .snapshot`` / ``recover``, ``runtime/fault.py``, ``checkpoint/``) on
    llama3.2-3b at full width and depth.  (a) the bench's
    ``fault_recovery`` leg (8 x 16 blocks, 8 checkpoint slots, 3 prompts
    of 24 tokens, 6 rounds): a launch failure at round 1 and a donation
    error on the third admission at round 3, recovered in place against a
    clean twin with the same checkpoint stream: tokens bitwise equal,
    ``fired`` as injected, the serve flush back to <= 1 launch within 2
    rounds and after, the checkpoint stream running; ``recover()``'s wall
    ms and K1 launches, the harvest ms a round.  (b) a quiesced
    ``PoolCheckpoint.drain()`` pass into a temporary directory, 3 copy
    flushes, ``k`` and ``v`` killed, ``recover(snapshot=latest())``: the
    pools restored and bitwise equal after replaying the 3 flushes; K1's
    card ms per replayed flush against its bound and the ms to save a
    pass; a second kill and recovery with every replayed K1 call held
    against its plain version (``K1Tap``).  (c) a mid-flush abort of 600
    copies over 1,280-block pools: the 512-row prefix journaled aborted,
    the suffix re-drained (tapped), pools bitwise equal to a clean twin's.

19. (run after phase 18, on phase 5's weights) the observability half
    (``phase_observability``; ``core/sanitizer.py``, ``obs/trace.py``, the
    core's ``drain.*`` / ``queue.*`` / ``engine.bytes_*`` series,
    ``obs/autotune.py``, ``launch/autotune.py``) on llama3.2-3b at full
    width and depth.  (a) a ``ServingEngine`` sanitized through
    ``REPRO_SANITIZE=1`` (every chunk shadow-drained by the plain version
    on host copies, bitwise), the twin's script (two admissions, a fork, 4
    rounds, a third admission and a round) with every K2 / K3 call
    tapped, a check run left out of the path's count; every report ok,
    ``tables_checked == shadow_runs ==`` K1 launches, tokens equal to an
    unsanitized twin's, then a planted K1 fault caught as ``shadow-diff``.
    (b) the twin's counters equal its journal, tickets and K1's counter.
    (c) an admission and its round under ``torch.profiler``: K1 launched
    inside a ``drain`` range nested in a ``flush`` range; the ticket's
    host ``drain_us`` beside K1's device time.  (d) rounds and 64-row
    flushes with observability on and off, in turns (printed, not gated).
    (e) the autotuner's flush matrix over two ``(28, 1024, 64, 8, 128)``
    bf16 pools and its ring sweep, into a temporary directory: 1.0
    launches a flush, every bucket set's K1 calls and a 600-row flush (one
    1,024-row table) bitwise against the plain version, the profile read
    back, and ServingEngine's ring resolved kwarg > profile > policy on
    the card.

20. (run after phase 19) K7 and the sharded bulk-movement drain over a
    rank mesh on one card, at llama3.2-3b's full pool width (blocks of 28
    layers x 64 tokens x 8 KV heads x 128 dims, bf16, block axis 1;
    ``phase_mesh``).  (a) K7's constants and its library plan
    (``rc_psm_plan``) against the Python statement (``plan_rows``) on
    1,000 seeded random calls (1-8 ranks, 1-3 tables, shared and
    unaligned slabs on two cards, refused rows of every kind); K7 alone
    over 4 and 8 ranks on cuda:0 (slabs of 32 blocks, rows at every hop
    -(n-1) .. n-1 with skip rows) bitwise against its plain version, one
    launch a call; card, device, plain and library
    (``index_copy_(index_select)`` per rank pair) ms beside the byte
    bound, the wrapper's host us a call and the route (bulk or word,
    items, grid, chunk); the same 8 ranks with one base 8 bytes off (the
    word loop) and a call of more rows than the launch parameters carry
    (llama3.2-3b's per-layer pages, the rows through the pinned and the
    device buffer), both bitwise in one launch.  (b) engines over (1, 4)
    ranks of ``("data", "model")`` (K / V of 256 blocks, a staging ring
    of 32 slots, sharded and then replicated on every rank), the fan-out
    and the single-slab fused engine on three seeded property programs:
    pools bitwise three ways,
    one ``fused_mesh`` notify a flush with the sharded ring, K7 and K1
    device launches a flush printed.  (c) ``plan_rebalance`` on a cache
    over the mesh engine: the plan and the pools bitwise equal to one
    device's, blocks moved across ranks through K7.  (d) a snapshot,
    more flushes, every pool killed, ``recover(snapshot=)``: bitwise.
    (e) with two cards or more, (a) with ranks on distinct cards after
    enabling peer access; with one, ``peer leg: 1 card visible, not
    run``.

21. (run last, every earlier model freed) training (``phase_train``;
    ``launch/train.py``, ``data/``, ``optim/``, ``LanguageModel.loss_fn``).
    (a) llama3.2-3b at full width and depth (28 layers, 3.21 B fp32 master
    parameters from seed 0, bf16 views) for 8 steps of ``make_train_step``
    with the ``TrainConfig`` that ``train_loop`` builds for 8 steps
    (warm-up 1), remat ``"minimal"``, ``make_batch`` batches of B = 2 x
    S = 1,024 (B = 1 if the peak passed 75 GB): the memory reckoning
    before, ``max_memory_allocated`` after, every loss and grad_norm
    finite, step 0's loss within [ln V - 1, ln V + 2], lr following
    ``cosine_schedule``; ms a step (median of steps 2-7), tokens/s, and
    a profile of one step split into the training attention, the matrix
    products, the optimizer, the rest and the host gap.  (b) llama3.2-3b
    and yi-6b reduced, 3 steps on the card and on the CPU from the same
    weights and batches: losses, grad_norm and the updated weights agree
    within the stated tolerances.  (c) reduced ``train_loop`` on the
    card: 20 steps, then a failure at 15 with a checkpoint every 10 and
    a resume whose losses equal steps 10-19; microbatches 2 against 1;
    mamba2-780m, zamba2-2.7b and deepseek-moe-16b finite.  No K1-K7
    launch in the phase.

22. (run after phase 20, on phase 5's weights) sharded serving over a rank
    mesh (``phase_mesh_serve``; ``ServingEngine(mesh=)``,
    ``PagedCoWCache(batch_groups=)``, the mesh branch of
    ``paged_attend_append`` and ``lse_combine``): llama3.2-3b at full width
    and depth over 8 ranks of the card ((2, 4) over ``("data", "model")``,
    ``max_seqs`` 8, 64 blocks a sequence, 4 allocator slabs: 512 blocks of
    3,670,016 B a pool, slabs of 64 blocks, 2 batch groups, a 64-slot
    sharded ring).  (a) phase 5's protocol against the single-device
    engine, each round fed that engine's tokens: the mesh engine's own
    greedy choice equal at every step except where the single engine's
    top-1 / top-2 margin is within twice the largest |logit| difference of
    the two on that step (logged with its position), logits within
    ``SERVE_RTOL``; at most one ``fused_mesh`` drain a round, K2 28 x 8 a
    round, K3 28 per admission, every block in its sequence's group, K1
    and K7 on the path; one layer's 8 partials combined in fp32 against
    the plain version's one sweep of the gathered pool (``K2_ATOL``); every
    K2 / K3 call of the admissions and the first round against its plain
    version (``tapped``).  (b) a cross-group fork (group 0 filled with CoW
    children): the child in group 1, its copies in the round's single
    drain with K7, bitwise equal to the parent's blocks.  (c) a replicated
    3-slot ring for 3 rounds of a 150-token admission: one ``fused_mesh``
    drain a round, tokens as in (a) against the single-device engine with
    the same ring.  (d) ms a round of both engines beside the card's name
    and power limit; one profiled steady round and one profiled round with
    a second cross-group fork: K2, K1, K7 and the LSE combine's device ms,
    the host gap, the idle share.

23. (run after phase 16, every earlier model freed) the model layer over a
    rank mesh (``phase_mesh_model``; ``prefill_state(mesh=)`` /
    ``decode_state(mesh=)`` over per-rank slabs, ``moe_ffn``'s mesh
    paths).  (a) paligemma-3b, zamba2-2.7b and seamless-m4t-medium at full
    width and depth over 8 ranks of the card ((2, 4) over ``("data",
    "model")``), B = 4 so the share mask has 2 local columns: 4 x (256
    patches + 128), 4 x 384 and 4 x 512 over 128 frames, 128 tokens of
    decode room (the block count a multiple of 8), the prefill and 16
    decode steps fed the single-device facade's greedy tokens.  K3 (and
    K4) per prefill as phases 11, 14 and 16, K2 == attention layers x 8 a
    step (144 / 72 / 96), logits within ``SERVE_RTOL`` of the
    single-device facade's in the same call (argmax mismatches printed
    with their top-1 / top-2 margin), every K2 / K3 / K4 call of the
    prefill and the first step against its plain version (``tapped``), ms
    a step on the mesh and on one device, one profiled step.  (b)
    deepseek-moe-16b at full width and depth in ``ServingEngine(mesh=)``
    over ``("model",)`` 8 (8 experts a rank): admissions of 96, 384, 250
    and 512 tokens, each FFN on the all-to-all path exactly where 8
    divides the length (``moe.PATH_COUNTS``), 8 rounds with K2 == 28 x 8;
    then layer 14's ``moe_ffn_a2a`` on the 384-token admission's captured
    input over the 8 card ranks against 8 CPU ranks: every rank's kept
    routes equal, the output within the bf16 tolerance, and the rows where
    ``moe_ffn_local`` differs counted.

24. (run after phase 21, with phase 21's model freed) training over a
    rank mesh (``phase_mesh_train``; ``make_train_step(mesh=)``,
    ``build_train_step``, the placed ``TrainState``, the placed step:
    every block of the loss and its backward on the rank that holds it,
    the moe placed paths with their aux, ``runtime/elastic.py``).
    (a) llama3.2-3b at full width and depth over 8 ranks of the card
    ((2, 4) over ``("data", "model")``) under ``"fsdp"``, phase 21 (a)'s
    ``TrainConfig``, weights (seed 0) and 8 batches: each step's loss and
    grad_norm against phase 21 (a)'s within ``MESH_LOSS0_RTOL`` /
    ``MESH_LOSS_RTOL`` / ``MESH_GNORM0_RTOL``, every grad_norm within
    ``MESH_GNORM_RTOL`` or ``MESH_DRIFT_FACTOR`` times the furthest that
    one device's step over the same batches in ``MESH_TWIN_MICROBATCHES``
    microbatches (the same per-sequence partial sums) strays from phase
    21 (a)'s, ms a step (the median of steps 2-7) and its ratio to phase
    21's, ``max_memory_allocated`` beside phase 21's, the bytes of
    masters and moments each rank holds (stored once), a profile of one
    step (idle share), then (after every leg is timed) the walk of one
    step on ``meta`` ranks sharing one device: its peak against the
    steps' own peak, and the bytes each rank gathered (weights' ZeRO-3
    blocks, activation rows).  (b) the same under ``"tp"``
    (``DEFAULT_RULES``: heads over ``model``, the batch over ``data``), 3
    steps, step 0's loss within ``MESH_TP_LOSS0_RTOL``.  (e) the same
    under ``"fsdp"`` at B =
    ``MESH_FULL_B`` (the batch over ``("data", "model")``: every rank
    holds a sequence), 3 steps, against one device's steps over the same
    batches.  (c) deepseek-moe-16b at published width (64
    experts top 6) cut to ``MOE_TRAIN_LAYERS`` layers (the reckoning
    printed), 3 steps over ``("model",)`` 8 under ``"tp"`` (the
    all-to-all) and ``("data",)`` 8 under ``"fsdp"``: forward and
    recomputed path counts, finite losses, step 0's within [ln V - 1,
    ln V + 2] beside the loss without a mesh under ``no_grad``; then one
    layer's loss and grads (fp32 activations) over 8 card ranks against 8
    CPU ranks: routes equal, loss and grads within the stated limits.
    (d) ``train_loop``
    of llama3.2-3b reduced over the 8 ranks, a checkpoint every 5 steps
    and a ``NodeFailure`` at 7, ``plan_remesh`` to 4 ranks,
    ``elastic_restore`` onto them and the steps resumed: losses of steps
    5-9 against the run without a failure (``ELASTIC_RTOL``).  No K1-K7
    launch in the phase.
25. (run last, on a card no earlier phase holds) the dry-run
    (``phase_dryrun``; ``launch/dryrun.py``, ``launch/op_cost.py``,
    ``kernels/cost.py``).  (a) phase 21's cell (llama3.2-3b, fp32
    masters, B = 2 x S = 1,024, remat ``"minimal"``), the placed step
    over (2, 4) ranks under ``"fsdp"``, walked over ``meta`` ranks
    sharing one device against the real step over 8 ranks of the card:
    the walk's peak against ``max_memory_allocated``
    (``DRY_PEAK_RTOL``), its FLOPs over the ranks equal to
    ``FlopCounterMode``'s over the step, its roofline time at most the
    step's device busy ms.  (b) phase 5's serving cells at full width:
    one decode round over 8 sequences x 64 full blocks and a 512-token
    prefill, walked; K2's and K3's calls (one a layer) and bytes a call
    equal to phases 2 and 4's rule over card tensors of the same calls.
    (c) ``python -m repro_torch.launch.dryrun --mesh single`` over every
    (arch, shape), a process a cell, ``DRY_WORKERS`` at once, cheapest
    first, for ``DRY_SWEEP_S`` seconds (up to ``DRY_SWEEP_GRACE_S`` more
    until a prefill_32k and a decode_32k cell are ok), beside (a) and
    (b): each row, the counts of ok / skip / error / not finished and the
    time; an error, or no ok cell of either kind, fails the phase.  No
    K1-K7 launch: the walk reckons kernels at their boundary.  The
    serving cells (all placed) come first by their layers, the train
    cells last.
26. (run after phase 22, on phase 5's weights) the dense decoder's
    serving weights placed over a rank mesh (``phase_placed_serve``;
    ``weights.place_params``, ``prefill`` / ``decode_step`` on placed
    weights, ``ServingEngine(mesh=)``): llama3.2-3b at full width and
    depth, a second copy of phase 5's weights placed over (2, 4) ranks of
    the card by ``DEFAULT_RULES``.  (a) phase 5's protocol through the
    single-device engine and phase 22's unplaced mesh engine; (b) each
    rank's weight bytes at rest (``rank_bytes``) within 5% of an eighth,
    every matrix split, the memory placing took; (c) the placed engine fed
    the single engine's tokens: its own greedy choice equal but at logged
    near-ties (phase 22's rule), logits within ``SERVE_RTOL``, at most one
    ``fused_mesh`` drain a round, K2 28 x 8 a round, K3 28 x 4 per
    admission (one a block of heads), K1 and K7 on the path, every K2 /
    K3 call of the admissions and the first round against its plain
    version (``tapped``), ``max_memory_allocated``; (d) ms a round of the
    three engines and one profiled round of the placed one; (e) K3 with
    ``q_offset`` on the last 2,048 query rows of a 4,096 prefill against
    its plain version (within ``K3_OFFSET_RTOL`` x its max |value|) and
    the whole prefill's rows (bitwise), card and device ms beside its
    bound, the plain version and SDPA with the offset mask; (f)
    ``PLACED_DRY_CELLS`` walked with placed weights (a process each,
    started once (a)-(e) are timed, beside (c)'s check run): the decode
    cells under 8 GiB of arguments on the busiest rank, the prefill cells
    within 74.5 GiB.
27. (run after phase 23, every earlier model freed, before phase 21) the
    moe decoder's serving weights placed over a rank mesh
    (``phase_placed_moe``; ``models/moe.py moe_ffn_placed``):
    deepseek-moe-16b at full width and depth, seed 0.  (a) phase 12's
    protocol through the single-device engine, its tokens, logits, slots
    and routes (``moe.RouteLog``) kept on the host, and a batched prefill
    of 2 x 512 on one device and over (2, 4) on the whole weights (the
    all-to-all); (b) the same model placed in place over (2, 4)
    (``place_params`` drops each whole weight as it places it): each
    rank's weight bytes within 5% of an eighth, the peak of placing; (c)
    the placed ``ServingEngine(mesh=)`` fed (a)'s tokens: greedy choices
    by phase 22's near-tie rule, logits within ``SERVE_RTOL``, route flips
    counted against (a)'s routes with the rows matched through the two
    engines' slots (replayed under (a)'s routes where the logits differ
    with flips), K2 28 x 8 a round, K3 28 x 4 per admission, at most one
    ``fused_mesh`` drain a round, K1 and K7 on the path, the local moe
    path in every admission and round, every K2 / K3 call of the
    admissions and first round against its plain version; (d) the placed
    batched prefill: the all-to-all in all 28 layers, logits within
    ``SERVE_RTOL`` of the unplaced mesh prefill's; (e) ms a round placed
    and single-device and one profiled round (the expert products, take's
    joins, K2, the host gap, the idle share); (f) phi3.5-moe cut to 8 of
    32 layers: a batched prefill (the all-to-all) and 3 decode steps
    placed over (2, 4) against the unplaced run; (g) deepseek's and
    phi3.5's decode_32k cells walked with placed weights (a process each,
    started once (a)-(e) are timed, beside (c)'s check run and (f)): equal
    to the CPU walk's rows, under 4 GiB of arguments on the busiest
    rank.
28. (run after phase 27, before phase 21) the facades' serving weights
    placed over a rank mesh (``phase_placed_facades``; ``models/mamba2.py
    mamba2_layer_placed``, ``models/lm.py state_logical_axes``), at
    published widths, seed 0: (a) mamba2-780m (48 layers) and
    zamba2-2.7b (54) over (2, 4), (b) paligemma-3b over (1, 16), the
    production ``model`` size (its 8 heads take ``"seq"``: K3 on row
    blocks of 40 at ``q_offset`` with the 256-patch prefix), (c)
    seamless-m4t-medium over (2, 4).  Each leg: the single-device facade
    (``prefill_state`` at B = 2 over a 384-token prompt, 8 greedy
    ``decode_state`` steps), then the same weights placed in place
    (``rank_bytes`` at rest, the peak of placing) fed its tokens: logits
    within ``SERVE_RTOL`` (where a Mamba2 leg's free run drifts past it,
    held again with each Mamba2 layer fed one device's input: phase 12's
    replay, ``_LayerReplay``), tokens equal but at logged near-ties, K4 once a
    Mamba2 layer and head block, K3 once an attention layer and block, K2
    once a layer and slab a step; every K2 / K3 / K4 call of the prefill
    and the first step against its plain version (``tapped``); ms a
    prefill and a step against one device and one profiled step's idle
    share (reported, not judged); K3 at the vlm's straddling row block
    and K4 at a rank's head block timed beside their bounds.  (d)
    ``ServingEngine(mesh=)`` over placed zamba2-2.7b and
    seamless-m4t-medium admits ``PROMPT_LENS``: the blocks staged and
    promoted, the per-sequence state and the logits against the unplaced
    mesh engine's (zamba2 replayed as in (a) where it drifts), at most one
    ``fused_mesh`` drain a round.  (e) The four
    facade decode_32k cells walked (a process each, started after (a)-(c)
    are timed): equal to the CPU walk's rows.

The last three lines are the ``kernels`` JSON (eight kernels; ``launches``
sums the main-path runs that ``launches_by_path`` lists), the card's name
and power limit, and the device JSON.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))


class _Cost:
    """``repro_torch.kernels.cost`` (the H100's peaks and every kernel's
    work), imported at first use: ``chip_ab.py`` imports this script
    before it puts the checkout it times on the path."""

    def __getattr__(self, name):
        from repro_torch.kernels import cost as module
        return getattr(module, name)


cost = _Cost()

SEED = 0
PROMPT_LENS = (96, 250, 384, 512)
ROUNDS = 16
MAX_SEQS = 8
MAX_BLOCKS_PER_SEQ = 64

# tolerances, with their reasons
#: K2: fp32 accumulation in another order and the fast exp; outputs are
#: O(1) averages of bf16 values
K2_ATOL = 2e-3
#: K3: bf16 output (one bf16 ulp at |x| ~ 2-4 is 1.6e-2), as the JAX tests
K3_ATOL = 2e-2
#: K3 over a block of query rows (phase 26 (e)): the outputs of N(0, 1)
#: inputs over 2,049-4,096 keys are small (mean |x| ~ 0.024, max ~ 0.5),
#: so the limit scales with them: one bf16 step at the largest output
#: value (both sides round one fp32 result once)
K3_OFFSET_RTOL = 2 ** -7
#: serve logits: 28 bf16 layers run through two attention implementations
#: (different summation orders, bf16 re-rounding of every activation)
SERVE_RTOL = 5e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 10, scrub=None) -> float:
    """Median device time of ``fn`` over ``reps`` launches, CUDA events;
    ``scrub`` (a large buffer) is rewritten before each launch so that the
    call finds the 50 MB L2 cold, as the serving path does."""
    from repro_torch.launch.mechanisms import time_ms as timed
    return timed(fn, torch.device("cuda"), reps=reps, scrub=scrub)


def device_ms(fn, key: str, reps: int = 5):
    """(device ms per launch, launches recorded) of the kernels whose name
    holds ``key``, over ``reps`` calls of ``fn`` (one such launch each)
    under ``torch.profiler``; (None, 0) when no launch was recorded.  Each
    call opens with a one-element write, so that no window starts on the
    kernel measured (the profiler may drop a window's first kernel,
    ROADMAP §3), and the time is divided by the launches the trace
    recorded: a dropped launch shows as a lower count, not a shorter
    time.  Unlike :func:`time_ms` it leaves out the host work between two
    launches."""
    from torch.profiler import ProfilerActivity, profile
    opener = torch.zeros(1, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            opener.add_(1)
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and key in e.key]
    count = sum(e.count for e in hits)
    total = sum(getattr(e, "self_device_time_total", 0.0) for e in hits)
    return (total / count / 1e3 if count else None), count


def _fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def _kernel_label(text: str) -> str:
    """``flash_kernel<256>`` for a line that names a mangled kernel
    instantiation (ptxas, cuobjdump), else the bare name it holds."""
    import re
    m = re.search(r"([A-Za-z_]*kernel)ILi(\d+)E", text)
    if m:
        return f"{m[1]}<{m[2]}>"
    m = re.search(r"([A-Za-z_]*kernel)", text)
    return m[1] if m else text.strip()[-60:]


def _sass_counts(sass, op: str) -> dict:
    """Lines holding ``op`` in each function of ``cuobjdump -sass``
    output, by :func:`_kernel_label`."""
    out, fn = {}, None
    for line in sass:
        if "Function : " in line:
            fn = _kernel_label(line.split("Function : ", 1)[1])
            out.setdefault(fn, 0)
        elif fn is not None and op in line:
            out[fn] += 1
    return out


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    from repro_torch.kernels import build
    build.build_all()
    log(f"[build] kernels built in {build.last_build_seconds:.1f} s")
    for name, out in build.last_build_log.items():
        entry = ""
        for line in out.splitlines():
            if "Compiling entry function" in line:
                entry = _kernel_label(line) + ": "
            elif "Used" in line or "spill" in line:
                log(f"[build] {name}: {entry}{line.strip()}")
    from repro_torch.kernels import paged_attention, ssd_chunk
    for mod in (paged_attention, ssd_chunk):
        for name, value in mod.kernel_constants().items():
            log(f"[build] {mod.__name__}.{name} = {getattr(mod, name)}, "
                f"library {value}")
            if getattr(mod, name) != value:
                raise AssertionError(f"{mod.__name__}.{name} disagrees with "
                                     "the library it describes")
    cuobjdump = Path(build.nvcc_path()).resolve().with_name("cuobjdump")
    for kernel, lib in (("K3", "flash_attention"), ("K4", "ssd_chunk")):
        sass = subprocess.run(
            [str(cuobjdump), "-sass", str(build.library_path(lib))],
            capture_output=True, text=True, check=True).stdout.splitlines()
        count = {op: sum(op in line for line in sass)
                 for op in ("HGMMA", "HMMA", "UTMALDG")}
        log(f"[build] {kernel} SASS (cuobjdump -sass lib{lib}.so): "
            + ", ".join(f"{n} {op}" for op, n in count.items()))
        if not count["HGMMA"]:
            raise AssertionError(f"{kernel} has no wgmma (HGMMA) instruction")
        if kernel == "K3":
            # every head dim's instantiation runs its products on wgmma
            per = _sass_counts(sass, "HGMMA")
            log(f"[build] K3 HGMMA per instantiation: {per}")
            from repro_torch.kernels.flash_attention import HEAD_DIMS
            missing = [D for D in HEAD_DIMS
                       if not per.get(f"flash_kernel<{D}>")]
            if missing:
                raise AssertionError(f"K3 at head dim {missing} has no wgmma "
                                     "(HGMMA) instruction")
    for kernel, lib in (("K1", "fused_dispatch"), ("K5", "fpm_copy"),
                        ("K6", "zero_init"), ("K7", "psm_transfer")):
        sass = subprocess.run(
            [str(cuobjdump), "-sass", str(build.library_path(lib))],
            capture_output=True, text=True, check=True).stdout.splitlines()
        n = sum("UBLKCP" in line for line in sass)
        log(f"[build] {kernel} SASS (cuobjdump -sass lib{lib}.so): {n} "
            "UBLKCP (bulk copy)")
        if not n:
            raise AssertionError(f"{kernel} has no bulk copy (UBLKCP)")
    from repro_torch.kernels import fused_dispatch as fd
    lib_consts, py_consts = fd.library_constants(), fd.constants()
    for name, value in py_consts.items():
        if lib_consts[name] != value:
            raise AssertionError(f"fused_dispatch.{name} = {value}, library "
                                 f"{lib_consts[name]}")
    log(f"[build] K1 constants equal the library's: {lib_consts}")
    return smi


def k1_serving_case(gen):
    """Phase 2's serving pools and table (also ``chip_ab.py``'s ``k1``
    row): K and V ``(28, 512, 64, 8, 128)`` bf16, a staging ring of 64
    blocks for each, and a 32-row table of 16 rows (every opcode, NOP
    padding, staging roles, non-adjacent write-after-read pairs: three
    waves).  Returns (pools, zero_blocks, table, primary)."""
    from repro_torch.core.opcodes import pack_bitwise_src
    from repro_torch.kernels import ref
    L, nblk, ring, page, kvh, D = 28, MAX_SEQS * MAX_BLOCKS_PER_SEQ, \
        MAX_BLOCKS_PER_SEQ, 64, 8, 128

    def pool(n):
        return torch.randn((L, n, page, kvh, D), generator=gen,
                           device="cuda").to(torch.bfloat16)

    pools = [pool(nblk), pool(nblk), pool(ring), pool(ring)]
    primary = (True, True, False, False)
    bases, total, _ = ref.address_space([nblk, nblk, ring, ring])
    K, V, KS, VS = bases
    pk = lambda a, b: pack_bitwise_src(a, b, total)   # noqa: E731
    rows = [
        (0, 10, 20), (1, 30, 200), (2, 40, 41), (3, -1, 50),
        (4, KS + 3, K + 60), (4, VS + 3, V + 60), (4, K + 70, KS + 5),
        (5, pk(K + 80, V + 81), K + 82), (-1, -1, -1),
        (6, pk(KS + 7, K + 83), V + 84), (7, pk(V + 85, V + 85), VS + 9),
        (0, 100, 101),
        (0, 90, 10),              # WAR on row 0's source, not adjacent
        (4, K + 91, KS + 3),      # WAR on a promotion's staging source
        (0, 102, 100),            # WAR on (0, 100, 101): wave 1
        (3, -1, 102),             # WAR on the row above: wave 2
    ]
    table = np.full((32, 3), -1, np.int32)
    table[:len(rows)] = rows
    zero_blocks = [torch.zeros((1, page, kvh, D), dtype=torch.bfloat16,
                               device="cuda") for _ in pools]
    return pools, zero_blocks, table, primary


def _k1_host_stages(pools, table, primary, block_axis, scrub,
                    reps: int = 20) -> dict:
    """K1's host work per call, stage by stage on the host clock (median of
    ``reps`` calls, each behind a queued ``scrub`` fill): the wrapper's
    checks (pool geometry, the table as a host array, the pool records),
    the library's plan alone (``rc_fused_plan`` through ``plan``, its
    Python call included), and one whole call of ``ops.fused_dispatch``."""
    from repro_torch.kernels import fpm_copy as fc
    from repro_torch.kernels import fused_dispatch as fd
    from repro_torch.kernels import ops
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sizes = [int(p.shape[block_axis]) for p in pools]
    names = ("checks", "plan", "wrapper")
    times = {k: [] for k in names}
    for _ in range(reps):
        scrub.zero_()
        t0 = time.perf_counter()
        layers, page_bytes, word = fc.block_geometry(pools, block_axis)
        fc.id_array(table, 3)
        fd._records(sizes, primary, [p.data_ptr() for p in pools])
        t1 = time.perf_counter()
        fd.plan(table, sizes, primary, layers=layers, page_bytes=page_bytes,
                bulk=word == 16, sms=sms)
        t2 = time.perf_counter()
        scrub.zero_()
        t3 = time.perf_counter()
        ops.fused_dispatch(pools, [], table, block_axis=block_axis,
                           primary=primary, use_kernel=True)
        t4 = time.perf_counter()
        torch.cuda.synchronize()
        for k, a, b in zip(names, (t0, t1, t3), (t1, t2, t4)):
            times[k].append((b - a) * 1e3)
    return {k: float(np.median(v)) for k, v in times.items()}


def _k1_held(pools, zero_blocks, table, primary, what, block_axis=1,
             max_grid=0, fresh=torch.clone) -> None:
    """K1 on copies (``fresh``) of ``pools`` against its plain version,
    bitwise, with ONE launch (none for a table without moves)."""
    from repro_torch.kernels import fused_dispatch as fd
    from repro_torch.kernels import ref
    want = [p.clone() for p in pools]
    ref.fused_dispatch(want, zero_blocks, table, block_axis=block_axis,
                       primary=primary)
    got = [fresh(p) for p in pools]
    before = fd.COUNTER.n
    fd.fused_dispatch_cuda(got, table, block_axis=block_axis,
                           primary=primary, max_grid=max_grid)
    torch.cuda.synchronize()
    bad = [i for i, (a, b) in enumerate(zip(got, want))
           if not _bitwise_equal(a, b)]
    if bad:
        raise AssertionError(f"K1 differs from its plain version in pools "
                             f"{bad} ({what})")
    launches = fd.COUNTER.n - before
    if launches != (1 if fd.last_out[1] else 0):
        raise AssertionError(f"K1: {launches} launches for "
                             f"{int(fd.last_out[1])} moves ({what})")
    del want, got


#: tables of phase 2's plan check, and the most rows of one
K1_TABLES, K1_ROWS = 1000, 512
#: pools of the plan check: two primaries and two staging pools (blocks)
K1_SIZES, K1_PRIMARY = (600, 600, 64, 64), (True, True, False, False)


def _random_k1_table(rng, sizes, primary, m):
    """One ``(m, 3)`` table of the plan check: every opcode, NOP padding
    (``op < 0``, and ``dst < 0`` under a live opcode), write-after-read
    pairs and chains (a row often writes a block an earlier row read: plain
    rows over cross-pool, bitwise and staging reads, and the reverse),
    packed bitwise sources (in place too), and with probability 0.1 a
    RAW or WAW row at the end; int32 or int64."""
    from repro_torch.kernels import ref
    bases, total, _ = ref.address_space(sizes)
    prim = [p for p, r in enumerate(primary) if r]
    nprim = min(sizes[p] for p in prim)
    w_all, w_pool, reads, rows = set(), set(), [], []

    def written(key):
        p, b = key
        if p < 0:
            return b in w_all or any((q, b) in w_pool for q in prim)
        return (p, b) in w_pool or (primary[p] and b in w_all)

    def any_key():
        p = int(rng.integers(len(sizes)))
        return p, int(rng.integers(sizes[p]))

    def gid(key):
        return bases[key[0]] + key[1]

    for _ in range(4 * m):
        if len(rows) >= m:
            break
        r = rng.random()
        if r < 0.1:
            rows.append((-1, -1, -1) if r < 0.08 else
                        (int(rng.integers(0, 8)), int(rng.integers(0, 9)),
                         -1))
            continue
        op = int(rng.choice([0, 1, 2, 3, 4, 4, 4, 5, 6, 7]))
        if reads and rng.random() < 0.4:
            dkey = reads[int(rng.integers(len(reads)))]   # a WAR pair
        else:
            dkey = (-1, int(rng.integers(nprim))) if op <= 3 else any_key()
        if op <= 3:
            if dkey[0] >= 0 and not primary[dkey[0]] or dkey[1] >= nprim:
                continue
            dkey = (-1, dkey[1])
            s = -1 if op == 3 else int(rng.integers(nprim))
            rkeys = [] if op == 3 else [(-1, s)]
            d = dkey[1]
        else:
            if dkey[0] < 0:
                dkey = (prim[int(rng.integers(len(prim)))], dkey[1])
            d = gid(dkey)
            if op == 4:
                rkeys = [any_key()]
                s = gid(rkeys[0])
            else:
                ka = dkey if rng.random() < 0.1 else any_key()  # in place
                kb = ka if op == 7 else any_key()
                s = gid(ka) * total + gid(kb)
                rkeys = [ka] if ka == kb else [ka, kb]
        if written(dkey) or any(written(k) for k in rkeys):
            continue
        rows.append((op, s, d))
        if dkey[0] < 0:
            w_all.add(dkey[1])
        else:
            w_pool.add(dkey)
        reads.extend(k for k in rkeys if k != dkey)
    hit = [(-1, b) for b in w_all] + sorted(w_pool)
    if hit and rng.random() < 0.1:        # break the contract on purpose
        key = hit[int(rng.integers(len(hit)))]
        if key[0] < 0:
            key = (prim[0], key[1])
        if rng.random() < 0.5:             # WAW
            rows.append((4, gid(any_key()), gid(key)))
        else:                              # RAW
            rows.append((4, gid(key), gid(any_key())))
    dtype = np.int32 if rng.random() < 0.5 else np.int64
    return np.asarray(rows, dtype).reshape(-1, 3)


def phase_k1_plan():
    """Phase 2b: the library's plan (``rc_fused_plan``) against
    ``plan_moves`` / ``chunking`` on :data:`K1_TABLES` seeded random
    tables of at most :data:`K1_ROWS` rows over :data:`K1_SIZES` (int32
    and int64), each then drained by the kernel over small bf16 pools
    (4 KiB pages in 2 layers, or 48 KiB pages, two chunks) against the
    plain version, bitwise, or refused with the Python message; every
    tenth table runs on a grid of 1, so that every kind of move goes
    through one CTA."""
    from repro_torch.kernels import fused_dispatch as fd
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(SEED + 2)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    sets = {shape: ([torch.randn((shape[0], n, shape[1]), generator=gen,
                                 device="cuda").to(torch.bfloat16)
                     for n in K1_SIZES]) for shape in ((2, 2048), (1, 24576))}
    counts = dict(tables=0, refused=0, multi_wave=0, deepest=0, moves=0,
                  above_params=0, grid1=0)
    for t in range(K1_TABLES):
        layers, width = ((2, 2048), (1, 24576))[t % 2]
        pools = sets[(layers, width)]
        page_bytes = width * 2
        zb = [torch.zeros((1, width), dtype=torch.bfloat16, device="cuda")
              for _ in pools]
        m = int(rng.integers(1, K1_ROWS + 1))
        table = _random_k1_table(rng, K1_SIZES, K1_PRIMARY, m)
        max_grid = 1 if t % 10 == 9 else 0
        try:
            want, waves = fd.plan_moves(table, K1_SIZES, K1_PRIMARY)
            msg = None
        except ValueError as e:
            msg = str(e)
        code, moves, out = fd.plan(table, K1_SIZES, K1_PRIMARY,
                                   layers=layers, page_bytes=page_bytes,
                                   bulk=True, sms=sms, max_grid=max_grid)
        counts["tables"] += 1
        if msg is not None:
            counts["refused"] += 1
            if code not in (fd.RAW, fd.WAW):
                raise AssertionError(f"table {t}: Python refused ({msg}), "
                                     f"library code {code}")
            try:
                fd.fused_dispatch_cuda(pools, table, block_axis=1,
                                       primary=K1_PRIMARY)
            except ValueError as e:
                if str(e) != msg:
                    raise AssertionError(f"table {t}: message {e!r}, "
                                         f"Python {msg!r}")
            else:
                raise AssertionError(f"table {t}: the wrapper did not "
                                     "refuse")
            continue
        chunk, _, items, grid = fd.chunking(len(want), layers, page_bytes,
                                            bulk=True, sms=sms)
        if max_grid:
            grid = min(grid, max_grid)
        n_waves = max(waves) + 1 if waves else 0
        expect = [len(waves), len(want), items, grid, chunk, n_waves, 1, -1]
        if code or not np.array_equal(moves, want) or \
                out.tolist() != expect:
            raise AssertionError(f"table {t}: library plan differs (code "
                                 f"{code}, out {out.tolist()}, Python "
                                 f"{expect})")
        counts["moves"] += len(want)
        counts["above_params"] += len(want) > fd.MOVE_CAPACITY
        counts["grid1"] += bool(max_grid)
        if n_waves > 1:
            counts["multi_wave"] += 1
            counts["deepest"] = max(counts["deepest"], n_waves)
        _k1_held(pools, zb, table, K1_PRIMARY, f"plan-check table {t}",
                 max_grid=max_grid)
    del sets
    log(f"[K1 plan] {counts['tables']} tables (<= {K1_ROWS} rows, "
        f"{counts['moves']} moves, {counts['above_params']} above the "
        f"parameters' {fd.MOVE_CAPACITY} moves, {counts['grid1']} on a grid "
        f"of 1): library plan equal to plan_moves / chunking; "
        f"{counts['refused']} refused with the Python message; "
        f"{counts['multi_wave']} multi-wave (up to {counts['deepest']} "
        "waves); pools bitwise equal to the plain version")


def phase_k1(scrub):
    """Phase 2: K1 on the serving table (bitwise, card / device / plain
    ms, the byte bound, host stages, a profile of one call), the plan
    check, a 512-row table at full width, unaligned pages, and a table of
    NOPs only."""
    from repro_torch.kernels import fused_dispatch as fd
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    pools, zero_blocks, table, primary = k1_serving_case(gen)
    sizes = [int(p.shape[1]) for p in pools]
    L, page_bytes = int(pools[0].shape[0]), pools[0][0, 0].nbytes
    _k1_held(pools, zero_blocks, table, primary, "serving table")
    out = fd.last_out.tolist()
    _, waves = fd.plan_moves(table, sizes, primary)

    def kern():
        ops.fused_dispatch(pools, zero_blocks, table, block_axis=1,
                           primary=primary, use_kernel=True)

    moved = cost.k1_bytes(table, sizes, primary, L, page_bytes)
    ms = time_ms(kern, scrub=scrub)
    dev, _ = device_ms(kern, key="drain_kernel")
    plain_ms = time_ms(lambda: ops.fused_dispatch(
        pools, zero_blocks, table, block_axis=1, primary=primary,
        use_kernel=False), reps=5, scrub=scrub)
    bound = moved / cost.HBM_BYTES_PER_S * 1e3
    log(f"[K1] bitwise equal to plain on {len(waves)} rows "
        f"({max(waves) + 1} waves, {out[1]} moves, chunk {out[4]} B, "
        f"{out[2]} items, grid {out[3]}, bulk {out[6]}); kernel {ms:.4f} "
        f"ms (device only {_fmt_ms(dev)}), plain {plain_ms:.4f} ms, bound "
        f"{bound:.4f} ms ({moved} bytes)")
    st = _k1_host_stages(pools, table, primary, 1, scrub)
    log("[K1] serving table host ms per call (median of 20): "
        + ", ".join(f"{k} {v:.4f}" for k, v in st.items()))
    trace = _profile_one_call(kern)
    launches = sum(n for k, n in trace["runtime"].items()
                   if "LaunchKernel" in k)
    log(f"[K1] profile of one call ({out[1]} moves, within the parameters' "
        f"{fd.MOVE_CAPACITY}): device events {trace['device']}, runtime "
        f"calls {trace['runtime']}; host-to-device copies or pinned "
        f"allocations: {trace['bad'] or 'none'}")
    if trace["bad"] or (trace["runtime"] and launches != 1):
        raise AssertionError(f"K1: {launches} launches, copies or pinned "
                             f"memory {trace['bad']} in one call")
    del pools
    torch.cuda.empty_cache()
    phase_k1_plan()
    # a full bucket of 512 rows at full width: above the parameters' room
    pools, zero_blocks, _, primary = k1_serving_case(gen)
    sizes = [int(p.shape[1]) for p in pools]
    rng = np.random.default_rng(SEED + 12)
    big = np.full((512, 3), -1, np.int32)
    rows = _random_k1_table(rng, sizes, primary, 512)
    while len(rows) < 300 or not _k1_contract(rows, sizes, primary):
        rows = _random_k1_table(rng, sizes, primary, 512)
    big[:len(rows)] = rows
    _k1_held(pools, zero_blocks, big, primary, "512-row table")
    out = fd.last_out.tolist()
    fn = lambda: ops.fused_dispatch(   # noqa: E731
        pools, zero_blocks, big, block_axis=1, primary=primary,
        use_kernel=True)
    big_ms = time_ms(fn, scrub=scrub)
    big_dev, _ = device_ms(fn, "drain_kernel")
    big_bound = cost.k1_bytes(big, sizes, primary, L, page_bytes) / \
        cost.HBM_BYTES_PER_S * 1e3
    log(f"[K1] 512-row table ({out[0]} live rows, {out[1]} moves through "
        f"the device buffer, {out[5]} waves): bitwise equal to plain, one "
        f"launch; kernel {big_ms:.4f} ms (device only {_fmt_ms(big_dev)}), "
        f"bound {big_bound:.4f} ms")
    # a table of NOPs only (and live opcodes with dst -1): no launch
    nops = np.full((32, 3), -1, np.int32)
    nops[::3, 0] = 0
    before = [p.clone() for p in pools]
    n0 = fd.COUNTER.n
    ops.fused_dispatch(pools, zero_blocks, nops, block_axis=1,
                       primary=primary, use_kernel=True)
    torch.cuda.synchronize()
    if fd.COUNTER.n != n0 or not all(_bitwise_equal(a, b)
                                     for a, b in zip(pools, before)):
        raise AssertionError("K1 launched or wrote for a table of NOPs")
    del pools, before
    torch.cuda.empty_cache()
    # unaligned pages (the word loop) and a base 4 bytes off
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        pools = [(torch.randn((n, 3, 17), generator=gen, device="cuda")
                  * 100).to(dtype) for n in K1_SIZES]
        zb = [torch.zeros((1, 3, 17), dtype=dtype, device="cuda")
              for _ in pools]
        table = _k1_contract_table(rng, K1_SIZES, K1_PRIMARY, 256)
        _k1_held(pools, zb, table, K1_PRIMARY, f"{dtype} pages of "
                 f"{pools[0][0].nbytes} bytes", block_axis=0)
        if fd.last_out[6]:
            raise AssertionError("an unaligned page took the bulk path")
    pools = [torch.randn((n, 8, 128), generator=gen, device="cuda")
             for n in K1_SIZES]
    zb = [torch.zeros((1, 8, 128), device="cuda") for _ in pools]
    table = _k1_contract_table(rng, K1_SIZES, K1_PRIMARY, 256)
    _k1_held(pools, zb, table, K1_PRIMARY, "a base 4 bytes off",
             block_axis=0, fresh=_offset_copy)
    if fd.last_out[6]:
        raise AssertionError("a base 4 bytes off took the bulk path")
    log("[K1] unaligned pages (float32 / bfloat16 / int32, 204 / 102 / 204 "
        "bytes) and a base 4 bytes off: bitwise equal to plain through the "
        "word loop; a table of NOPs: no launch")
    del pools
    return dict(name="fused_dispatch", source="src/repro_torch/csrc/"
                "fused_dispatch.cu",
                replaces="src/repro/kernels/fused_dispatch.py:406",
                max_abs_err=0.0, ms=ms, device_ms=dev, plain_ms=plain_ms,
                bound_ms=bound, bound_by="bytes", library_ms=None)


def _k1_contract(table, sizes, primary) -> bool:
    """Does ``table`` keep the contract (no RAW or WAW pair)?"""
    from repro_torch.kernels.fused_dispatch import wave_schedule
    live = [r for r in np.asarray(table, np.int64).tolist()
            if r[0] >= 0 and r[2] >= 0]
    try:
        wave_schedule(live, sizes, primary)
    except ValueError:
        return False
    return True


def _k1_contract_table(rng, sizes, primary, m):
    """A random table of :func:`_random_k1_table` that keeps the
    contract."""
    while True:
        table = _random_k1_table(rng, sizes, primary, m)
        if _k1_contract(table, sizes, primary):
            return table


#: K2 slab layouts of phases 2 and 9 (slot B-1 stays empty in each):
#: "serve", a forked 3-page prompt shared by sequences 0-2 and 1-8
#: private pages each; "long", sequence 0 over MAX_BLOCKS_PER_SEQ visible
#: pages (every CTA of the cluster busy; its first 3 shared with sequence
#: 1); "single", one page per sequence
K2_LAYOUTS = ("serve", "long", "single")


def _k2_layout(rng, nblk, B, page, layout):
    """share_mask (nblk, B) int8, base (nblk,) and seq_lens (B,) int32 of
    one :data:`K2_LAYOUTS` case."""
    mask = np.zeros((nblk, B), np.int8)
    base = np.zeros(nblk, np.int32)
    lens = np.zeros(B, np.int32)
    free = list(rng.permutation(nblk))
    shared = [free.pop() for _ in range(3)]
    for b in range(B - 1):
        if layout == "single":
            blocks = [free.pop()]
        elif layout == "long" and b == 0:
            blocks = shared + [free.pop()
                               for _ in range(MAX_BLOCKS_PER_SEQ - 3)]
        else:
            n = int(rng.integers(1, 9))
            sharers = 3 if layout == "serve" else 2
            blocks = (shared if b < sharers else []) + \
                [free.pop() for _ in range(n)]
        for j, blk in enumerate(blocks):
            mask[blk, b] = 1
            base[blk] = j * page
        lens[b] = (len(blocks) - 1) * page + int(rng.integers(1, page + 1))
    return mask, base, lens


def phase_k2(scrub, B=MAX_SEQS, H=24, KVH=8, D=128):
    """K2 against its plain version on each :data:`K2_LAYOUTS` slab; the
    default shapes are llama3.2-3b's serving slab, phase 9 passes zamba2's
    (B=4, H=KVH=32, D=80).  Card and device-only times of the "serve" and
    "long" layouts; the JSON row takes "serve"'s."""
    from repro_torch.kernels import ops
    page, nblk = 64, MAX_SEQS * MAX_BLOCKS_PER_SEQ
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    q = torch.randn((B, H, D), generator=gen, device="cuda").bfloat16()
    k = torch.randn((nblk, page, KVH, D), generator=gen,
                    device="cuda").bfloat16()
    v = torch.randn((nblk, page, KVH, D), generator=gen,
                    device="cuda").bfloat16()
    rows = {}
    for layout in K2_LAYOUTS:
        mask, base, lens = _k2_layout(rng, nblk, B, page, layout)
        args = (q, k, v, torch.from_numpy(mask).cuda(),
                torch.from_numpy(base).cuda(), torch.from_numpy(lens).cuda())

        def kern():
            return ops.paged_attention_slab(*args, page=page,
                                            use_kernel=True)

        acc, l, m = kern()
        acc_p, l_p, m_p = ops.paged_attention_slab(*args, page=page,
                                                   use_kernel=False)
        torch.cuda.synchronize()
        out = acc / l.clamp_min(1e-30)[..., None]
        out_p = acc_p / l_p.clamp_min(1e-30)[..., None]
        err = float((out - out_p).abs().max())
        err_m = float((m - m_p).abs().max())
        empty_ok = bool((m[B - 1] == -1e30).all() and (l[B - 1] == 0).all()
                        and (acc[B - 1] == 0).all())
        if not (err <= K2_ATOL and err_m <= K2_ATOL and empty_ok):
            raise AssertionError(f"K2 vs plain ({layout}): out err {err}, m "
                                 f"err {err_m}, empty slot ok {empty_ok}")
        live_blocks = int((mask.sum(1) > 0).sum())
        nbytes = cost.k2_work(*args, page=page).bytes
        bound = nbytes / cost.HBM_BYTES_PER_S * 1e3
        r = dict(err=max(err, err_m), bound=bound, ms=None, dev=None,
                 plain_ms=None)
        if layout != "single":
            r["ms"] = time_ms(kern, scrub=scrub)
            r["dev"] = device_ms(kern, key="paged_attn")[0]
        if layout == "serve":
            r["plain_ms"] = time_ms(lambda: ops.paged_attention_slab(
                *args, page=page, use_kernel=False), reps=5, scrub=scrub)
        rows[layout] = r
        log(f"[K2] B={B} H={H} KVH={KVH} D={D} {layout} ({live_blocks} live "
            f"blocks, longest {int(mask.sum(0).max())} pages): max |out - "
            f"plain| {err:.2e}, |m - plain| {err_m:.2e} (atol {K2_ATOL}); "
            f"empty slot m=-1e30 l=0; kernel "
            f"{_fmt_ms(r['ms'])} (device only {_fmt_ms(r['dev'])}), plain "
            f"{_fmt_ms(r['plain_ms'])}, bound {bound:.4f} ms ({nbytes} "
            "bytes)")
    r = rows["serve"]
    return dict(name="paged_attention", source="src/repro_torch/csrc/"
                "paged_attention.cu",
                replaces="src/repro/kernels/paged_attention.py:98",
                max_abs_err=max(x["err"] for x in rows.values()),
                ms=r["ms"], device_ms=r["dev"], plain_ms=r["plain_ms"],
                bound_ms=r["bound"], bound_by="bytes", library_ms=None)


#: K3 edge cases held against the plain version (B, S, causal,
#: prefix_len) at each head configuration: one token, one row past a tile,
#: a prefix-LM prefix across tiles, and full (non-causal) attention
K3_EDGES = ((1, 1, True, 0), (1, 65, True, 0), (1, 250, True, 100),
            (1, 250, False, 0))


#: phase 9's K3 cases at paligemma-3b's head dim 256, (B, S, prefix_len):
#: phase 14's batch prefill, then S = 512 and a ragged 313 with the
#: 256-patch prefix and without, at B = 1 (timed) and 4; its edge cases
#: are one token and one row past a tile at both batches
K3_CASES_256 = ((4, 384, 256),) + tuple(
    (B, S, prefix) for B in (1, 4) for S in (512, 313)
    for prefix in (256, 0))
K3_EDGES_256 = tuple((B, S, True, 0) for S in (1, 65) for B in (1, 4))


#: phase 9's K3 cases at seamless-m4t-medium's head dim 64 (16 heads over
#: 16 KV heads), (B, Sq, Skv, causal): phase 16's decoder self-attention
#: (causal, its batch prefill and its ragged prompt), encoder (non-causal,
#: Sq = Skv = 128 and 14) and cross-attention (512 text rows over 128
#: frames, 57 over 14, and one query over 128: the decode step's), then
#: the edges, one frame and 65 rows over 200; the first seven timed
K3_CASES_64 = ((4, 512, 512, True), (1, 57, 57, True),
               (4, 128, 128, False), (1, 14, 14, False),
               (4, 512, 128, False), (1, 57, 14, False),
               (4, 1, 128, False), (1, 65, 1, False), (1, 65, 200, False))


def _k3_inputs(gen, B, S, H, KVH, D, Skv=None):
    """q / k / v as the model hands them to K3: (B, S, heads, D)
    activations seen through (B, heads, S, D) views; k / v of ``Skv``
    positions (default S)."""
    Skv = S if Skv is None else Skv
    return [torch.randn((B, n_s, n, D), generator=gen, device="cuda")
            .bfloat16().transpose(1, 2)
            for n, n_s in ((H, S), (KVH, Skv), (KVH, Skv))]


def _k3_case(case) -> tuple:
    """(B, Sq, Skv, causal, prefix_len) of a ``phase_k3`` case: causal (B,
    S) or (B, S, prefix_len) over its own S, or (B, Sq, Skv, causal)."""
    if len(case) == 4:
        return tuple(case) + (0,)
    B, S, prefix = (tuple(case) + (0,))[:3]
    return B, S, S, True, prefix


def phase_k3(scrub, H=24, KVH=8, D=128, cases=((1, 512), (1, 250)),
             edges=K3_EDGES, timed=None):
    """K3 against its plain version for each case of ``cases`` (causal (B,
    S) or (B, S, prefix_len), or (B, Sq, Skv, causal)) and for the (B, S,
    causal, prefix_len) of ``edges``; the defaults are llama3.2-3b's heads
    at S=512 and a ragged S=250 and :data:`K3_EDGES`, phase 9 passes the
    other configs' heads and prefill shapes.  The first ``timed`` cases
    (all by default) are timed; the JSON row takes the first case's
    times."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    errs = []
    for B, S, causal, prefix in edges:
        q, k, v = _k3_inputs(gen, B, S, H, KVH, D)
        out = ops.flash_attention(q, k, v, causal=causal, prefix_len=prefix,
                                  use_kernel=True)
        want = ops.flash_attention(q, k, v, causal=causal,
                                   prefix_len=prefix, use_kernel=False)
        torch.cuda.synchronize()
        errs.append(float((out.float() - want.float()).abs().max()))
        if not errs[-1] <= K3_ATOL:
            raise AssertionError(f"K3 vs plain at B={B} S={S} causal="
                                 f"{causal} prefix_len={prefix}: max err "
                                 f"{errs[-1]}")
    if edges:
        log(f"[K3] H={H} KVH={KVH} D={D} edge cases (B, S, causal, "
            f"prefix_len) {edges}: max err "
            f"{', '.join(f'{e:.2e}' for e in errs)} (atol {K3_ATOL})")
    rows = {}
    for case in cases:
        B, S, Skv, causal, prefix = _k3_case(case)
        q, k, v = _k3_inputs(gen, B, S, H, KVH, D, Skv)
        what = f"S={S}" if Skv == S else f"Sq={S} Skv={Skv}"
        what += f" prefix_len={prefix}" if causal else " non-causal"

        def kern():
            return ops.flash_attention(q, k, v, causal=causal,
                                       prefix_len=prefix, use_kernel=True)

        out = kern()
        want = ops.flash_attention(q, k, v, causal=causal, prefix_len=prefix,
                                   use_kernel=False)
        torch.cuda.synchronize()
        err = float((out.float() - want.float()).abs().max())
        if not err <= K3_ATOL:
            raise AssertionError(f"K3 vs plain at B={B} {what}: max err "
                                 f"{err}")
        if timed is not None and len(rows) >= timed:
            rows[case] = dict(err=err)
            log(f"[K3] B={B} H={H} KVH={KVH} D={D} {what}: max err "
                f"{err:.2e} (atol {K3_ATOL}); not timed")
            continue
        ms = time_ms(kern, scrub=scrub)
        dev, _ = device_ms(kern, key="flash_kernel")
        plain_ms = time_ms(lambda: ops.flash_attention(
            q, k, v, causal=causal, prefix_len=prefix, use_kernel=False),
            reps=5, scrub=scrub)
        if prefix:
            rows_i = torch.arange(S, device="cuda")
            mask = (rows_i[None, :] <= rows_i[:, None]) | \
                (rows_i[None, :] < prefix)
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True), scrub=scrub)
        else:
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True), scrub=scrub)
        nbytes, flops = cost.k3_work(q, k, v, causal=causal,
                                     prefix_len=prefix)
        b_ops = flops / cost.BF16_FLOPS * 1e3
        b_bytes = nbytes / cost.HBM_BYTES_PER_S * 1e3
        log(f"[K3] B={B} H={H} KVH={KVH} D={D} {what}: max err {err:.2e} "
            f"(atol {K3_ATOL}); kernel {ms:.4f} ms (device only "
            f"{_fmt_ms(dev)}), plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, "
            f"bound {max(b_ops, b_bytes):.5f} ms ({flops:.3e} flop, {nbytes} "
            "bytes)")
        rows[case] = dict(err=err, ms=ms, dev=dev, plain_ms=plain_ms,
                          lib_ms=lib_ms, bound=max(b_ops, b_bytes),
                          by="operations" if b_ops >= b_bytes else "bytes")
    r = rows[cases[0]]
    return dict(name="flash_attention", source="src/repro_torch/csrc/"
                "flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:93",
                max_abs_err=max([x["err"] for x in rows.values()] + errs),
                ms=r["ms"], device_ms=r["dev"], plain_ms=r["plain_ms"],
                bound_ms=r["bound"], bound_by=r["by"],
                library_ms=r["lib_ms"])


#: profiler names of the attention, SSD and drain kernels (K2, K3, K4, K1)
PORT_KERNEL_KEYS = ("paged_attn", "flash_kernel", "ssd_intra",
                    "drain_kernel")
#: the moe stages that the profiles split out: (function of
#: ``models/moe.py``, the profiler range it runs in)
MOE_STAGES = (("route", "moe.routing"), ("expert_ffn", "moe.experts"),
              ("placed_experts", "moe.experts"))


#: name fragments of the cuBLAS / CUTLASS matrix-product kernels
GEMM_KEYS = ("gemm", "Gemm", "GEMM", "nvjet", "xmma", "cutlass")


def profile_rounds(step, rounds: int = 3, tag: str = "profile",
                   what: str = "round") -> None:
    """Where a steady step's time goes: torch.profiler over ``rounds`` more
    calls of ``step`` (after the counted run), with the moe stages
    (:data:`MOE_STAGES`) in ``record_function`` ranges.  Prints the wall
    and device busy ms and the device's idle share; the ten largest
    kernels, and K1's, K2's, K3's and K4's below them wherever they rank;
    then a split per step: K1, K2, K3, the kernels launched inside each moe range
    (the expert products, the routing; where none ran there, the range's
    span on the device) or, where no moe range ran, the matrix-product
    kernels (:data:`GEMM_KEYS`), the rest of the device time, and the host
    gap (wall - busy)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import moe
    saved = {name: getattr(moe, name) for name, _ in MOE_STAGES}

    def ranged(fn, label):
        def call(*args, **kw):
            with record_function(label):
                return fn(*args, **kw)
        return call

    for name, label in MOE_STAGES:
        setattr(moe, name, ranged(saved[name], label))
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(rounds):
                step()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        for name, fn in saved.items():
            setattr(moe, name, fn)
    cuda = torch.autograd.DeviceType.CUDA
    labels = [label for _, label in MOE_STAGES]
    inside = {label: 0.0 for label in labels}
    span = {label: 0.0 for label in labels}
    rows = []
    for avg in prof.key_averages():
        if avg.key in inside:
            # the CPU range's device total sums the kernels launched in it;
            # the device-side annotation is the range's span, not a kernel
            if avg.device_type == cuda:
                span[avg.key] += getattr(avg, "self_device_time_total", 0.0)
            else:
                inside[avg.key] += getattr(avg, "device_time_total", 0.0)
            continue
        # device-side events only (kernels, memcpy, memset): a CPU op's
        # device time repeats the kernels it launched
        if avg.device_type != cuda:
            continue
        dev = getattr(avg, "self_device_time_total", 0.0)
        if dev > 0:
            rows.append((dev, avg.count, avg.key))
    busy = sum(r[0] for r in rows)
    if not busy:
        log(f"[{tag}] device time: not measured (the profiler recorded "
            "no kernel)")
        return
    log(f"[{tag}] {rounds} steady {what}s: wall "
        f"{wall_us / rounds / 1e3:.2f} ms/{what}, device busy "
        f"{busy / rounds / 1e3:.2f} ms/{what}, idle share "
        f"{1 - busy / wall_us:.3f}")
    ranked = sorted(rows, reverse=True)
    for i, (dev, count, key) in enumerate(ranked):
        if i < 10 or any(k in key for k in PORT_KERNEL_KEYS):
            log(f"[{tag}]   {dev / rounds / 1e3:8.3f} ms/{what} "
                f"{count // rounds:5d} calls/{what}  {key[:90]}")

    def per_step(us):
        return us / rounds / 1e3

    k2 = sum(r[0] for r in rows if "paged_attn" in r[2])
    k3 = sum(r[0] for r in rows if "flash_kernel" in r[2])
    drains = sum(r[0] for r in rows if "drain_kernel" in r[2])
    other = busy - k2 - k3 - drains - sum(inside.values())
    stages = "".join(
        f", {name} {per_step(inside[label] or span[label]):.3f} ms ("
        f"{'kernels in range' if inside[label] else 'range span'})"
        for name, label in (("expert products", "moe.experts"),
                            ("routing", "moe.routing"))
        if inside[label] or span[label])
    if not stages:
        # a moe range's kernels hold its products: split the GEMMs out only
        # where no range ran, so that no kernel counts twice
        mm = [r for r in rows if any(g in r[2] for g in GEMM_KEYS)
              and not any(k in r[2] for k in PORT_KERNEL_KEYS)]
        gemm = sum(r[0] for r in mm)
        other -= gemm
        stages += (f", GEMMs {per_step(gemm):.3f} ms "
                   f"({sum(r[1] for r in mm) // rounds} calls; the largest "
                   "kernel "
                   f"{max((r[0] for r in mm), default=0) / rounds / 1e3:.3f}"
                   " ms)")
    log(f"[{tag}] split per {what}: K1 {per_step(drains):.3f} ms, K2 "
        f"{per_step(k2):.3f} ms, K3 "
        f"{per_step(k3):.3f} ms{stages}, other device "
        f"{per_step(other):.3f} ms, host gap "
        f"{per_step(wall_us - busy):.2f} ms")


def _admit_all(eng, prompts):
    return [eng.add_request(p) for p in prompts]


# ---------------------------------------------------------------------------
# phases 6-8: the per-mechanism slice
# ---------------------------------------------------------------------------

#: flat pools of phase 6/7: the 28 x 512 pages phase 5's K pool holds
FLAT_NBLK = 28 * MAX_SEQS * MAX_BLOCKS_PER_SEQ
#: rows of one fan-out call (the engine's max_requests)
MAX_REQUESTS = 256


def _bf16_pool(shape, gen):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)


def _copy_ids(rng, nblk, m, n_src=None):
    """m live ``[src, dst]`` rows (dsts distinct, none a source) with one
    write-after-read pair (row m // 2 rewrites row 0's source, in-pool
    only), padded with -1 rows to 256 (m = 8) or by 8 rows (m = 256)."""
    if n_src is None:
        perm = rng.permutation(nblk)
        srcs, dsts = perm[:m], perm[m:2 * m].copy()
        dsts[m // 2] = srcs[0]
    else:
        srcs = rng.permutation(n_src)[:m]
        dsts = rng.permutation(nblk)[:m]
    pad = max(MAX_REQUESTS - m, 8)
    live = np.stack([srcs, dsts], 1)
    return np.concatenate([live, np.full((pad, 2), -1)]).astype(np.int32)


def _bitwise_equal(a, b) -> bool:
    return torch.equal(a.view(torch.int16), b.view(torch.int16))


def _block_move_stages(pool, ids, scrub, reps: int = 20) -> dict:
    """K5a's host work per call at axis 0, stage by stage on the host clock
    (median of ``reps`` calls, each behind a queued ``scrub`` fill): the
    wrapper's checks (pool geometry, the ids as a host array), the
    library's schedule alone (``rc_block_plan`` through ``plan``, its
    Python call included), ``block_move`` (the checks and the one C call:
    schedule and launch), and one whole call of the wrapper."""
    from repro_torch.kernels import fpm_copy as fc
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_dispatch import block_geometry
    n = pool.shape[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    names = ("checks", "schedule", "block_move", "wrapper")
    times = {k: [] for k in names}
    for _ in range(reps):
        scrub.zero_()
        t0 = time.perf_counter()
        layers, page_bytes, word = block_geometry((pool, pool), 0)
        fc.id_array(ids, 2)
        t1 = time.perf_counter()
        fc.plan(ids, 2, n, n, same_pool=True, layers=layers,
                page_bytes=page_bytes, bulk=word == 16, sms=sms)
        t2 = time.perf_counter()
        scrub.zero_()
        t3 = time.perf_counter()
        fc.block_move("rc_fpm_copy", pool, pool, ids, block_axis=0)
        t4 = time.perf_counter()
        scrub.zero_()
        t5 = time.perf_counter()
        ops.fpm_copy(pool, ids, use_kernel=True)
        t6 = time.perf_counter()
        torch.cuda.synchronize()
        for k, a, b in zip(names, (t0, t1, t3, t5), (t1, t2, t4, t6)):
            times[k].append((b - a) * 1e3)
    return {k: float(np.median(v)) for k, v in times.items()}


#: tables of phase 6's schedule check, and the most rows of one
SCHEDULE_TABLES, SCHEDULE_ROWS = 1000, 264


def _random_table(rng, nblk, m, same_pool):
    """One ``(m, 2)`` ``[src, dst]`` table of the schedule check: WAR
    chains (a row rewrites an earlier row's source), padding, sources out
    of range both ways, and with probability 0.1 a RAW or WAW pair."""
    rows, written, srcs = [], set(), []
    for _ in range(m):
        r = rng.random()
        if r < 0.15:
            rows.append((int(rng.integers(-3, nblk + 3)), -1))
            continue
        s = int(rng.integers(-2, nblk + 2)) if r < 0.2 else \
            int(rng.integers(0, nblk))
        if srcs and rng.random() < 0.4:
            d = srcs[int(rng.integers(0, len(srcs)))]   # WAR: chains
        else:
            d = int(rng.integers(0, nblk))
        cs = min(max(s, 0), nblk - 1)
        if d in written or (same_pool and cs in written):
            continue
        rows.append((s, d))
        written.add(d)
        srcs.append(cs)
    if rows and rng.random() < 0.1:       # break the contract on purpose
        live = [r for r in rows if r[1] >= 0]
        if live:
            a = live[int(rng.integers(0, len(live)))]
            rows.append((a[1], int(rng.integers(0, nblk))) if same_pool
                        and rng.random() < 0.5 else (0, a[1]))
    dtype = np.int32 if rng.random() < 0.5 else np.int64
    return np.asarray(rows, dtype).reshape(-1, 2)


def _python_schedule(ids, nblk, same_pool):
    """The Python statement of the schedule: (rows, waves) or the
    ValueError text."""
    from repro_torch.kernels import fpm_copy as fc
    rows = fc._live_pairs(ids, nblk, nblk)
    try:
        return rows, fc.pair_waves(rows, same_pool=same_pool)
    except ValueError as e:
        return str(e), None


def phase_schedule():
    """Phase 6a: the library's schedule (``rc_block_plan``) against
    ``_live_pairs`` / ``pair_waves`` / ``launch_rows`` / ``chunking`` on
    :data:`SCHEDULE_TABLES` seeded random tables of at most
    :data:`SCHEDULE_ROWS` rows, in-pool and pool-to-pool, int32 and int64
    ids, then each table through the kernel over a small bf16 pool (one
    tensor, or two for K5b) against the plain version, bitwise, or the
    same ``ValueError`` text from the wrapper; K6's width-1 ids likewise.
    The design constants against the library's."""
    from repro_torch.kernels import fpm_copy as fc
    from repro_torch.kernels import ops
    consts = fc.library_constants()
    for name, value in consts.items():
        if name != "param_bytes" and getattr(fc, name) != value:
            raise AssertionError(f"fpm_copy.{name} = {getattr(fc, name)}, "
                                 f"library {value}")
    log(f"[schedule] constants equal the library's: {consts}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(SEED + 6)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    nblk, page = 600, (16, 128)                      # 4 KiB bf16 pages
    pool = _bf16_pool((nblk,) + page, gen)
    other = _bf16_pool((nblk,) + page, gen)
    counts = dict(tables=0, refused=0, multi_wave=0, deepest=0, rows=0)
    for t in range(SCHEDULE_TABLES):
        same = t % 3 != 2
        m = int(rng.integers(1, SCHEDULE_ROWS + 1))
        ids = _random_table(rng, nblk, m, same)
        want_rows, waves = _python_schedule(ids, nblk, same)
        code, rows, out = fc.plan(ids, 2, nblk, nblk, same_pool=same,
                                  layers=1, page_bytes=4096, bulk=True,
                                  sms=sms)
        counts["tables"] += 1
        if waves is None:
            counts["refused"] += 1
            if code not in (fc.RAW, fc.WAW):
                raise AssertionError(f"table {t}: Python refused "
                                     f"({want_rows}), library code {code}")
            try:
                (ops.fpm_copy(pool, ids, use_kernel=True) if same else
                 ops.fpm_copy_cross(pool, other, ids, use_kernel=True))
            except ValueError as e:
                if str(e) != want_rows:
                    raise AssertionError(f"table {t}: message {e!r}, "
                                         f"Python {want_rows!r}")
            else:
                raise AssertionError(f"table {t}: the wrapper did not "
                                     "refuse")
            continue
        want = fc.launch_rows(want_rows, waves)
        plan = fc.chunking(len(want), 1, 4096, bulk=True, zero=False,
                           sms=sms)
        got_plan = (int(out[5]), int(out[3]), int(out[4]))
        if code or not np.array_equal(rows, want) or \
                int(out[6]) != (int(waves.max()) + 1 if len(waves) else 0) \
                or (len(want) and got_plan != (plan[0],) + plan[2:]):
            raise AssertionError(f"table {t}: library schedule differs "
                                 f"(code {code}, out {out.tolist()}, plan "
                                 f"{plan})")
        counts["rows"] += len(want)
        if len(waves) and waves.max() > 0:
            counts["multi_wave"] += 1
            counts["deepest"] = max(counts["deepest"], int(waves.max()) + 1)
        for target in ("pool", "zero"):
            if target == "zero":
                zids = ids[:, 1].copy()
                zw = ops.meminit_zero(pool.clone(), zids, use_kernel=False)
                zg = ops.meminit_zero(pool.clone(), zids, use_kernel=True)
            elif same:
                zw = ops.fpm_copy(pool.clone(), ids, use_kernel=False)
                zg = ops.fpm_copy(pool.clone(), ids, use_kernel=True)
            else:
                zw = ops.fpm_copy_cross(pool.clone(), other, ids,
                                        use_kernel=False)
                zg = ops.fpm_copy_cross(pool.clone(), other, ids,
                                        use_kernel=True)
            if not _bitwise_equal(zg, zw):
                raise AssertionError(f"table {t} ({target}, same pool "
                                     f"{same}): the kernel's pool differs "
                                     "from the plain version's")
    torch.cuda.synchronize()
    log(f"[schedule] {counts['tables']} tables (<= {SCHEDULE_ROWS} rows, "
        f"{counts['rows']} live rows): library schedule equal to "
        f"pair_waves / launch_rows / chunking; {counts['refused']} "
        f"refused with the Python message; {counts['multi_wave']} "
        f"multi-wave (up to {counts['deepest']} waves); pools bitwise "
        "equal to the plain versions (K5a, K5b, K6)")


def _chain_ids(rng, nblk, chains, depth):
    """``chains`` WAR chains of ``depth`` rows each, interleaved: row j of
    a chain writes row j-1's source, so the chain takes ``depth`` waves."""
    blocks = rng.permutation(nblk)[:chains * (depth + 1)]
    rows = []
    for j in range(depth):
        for c in range(chains):
            b = blocks[c * (depth + 1):(c + 1) * (depth + 1)]
            rows.append((b[j + 1], b[j]))
    return np.asarray(rows, np.int32)


def _offset_copy(x, offset=None):
    """A contiguous copy of ``x`` whose data starts ``offset`` bytes (one
    element by default) past an aligned address."""
    offset = x.element_size() if offset is None else offset
    nbytes = x.numel() * x.element_size()
    raw = torch.empty(nbytes + 16, dtype=torch.uint8, device=x.device)
    out = raw[offset:offset + nbytes].view(x.dtype).view(x.shape)
    out.copy_(x)
    return out


def _profile_one_call(fn) -> dict:
    """One call of ``fn`` under torch.profiler: its device events and the
    CUDA runtime calls it made; a host-to-device copy or a pinned
    allocation fails the run."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device, runtime = {}, {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device[e.key[:40]] = e.count
        elif e.key.startswith("cuda"):
            runtime[e.key] = e.count
    bad = [n for n in list(device) + list(runtime)
           if "HtoD" in n or "Memcpy" in n or "HostAlloc" in n
           or "MallocHost" in n or "HostRegister" in n]
    return dict(device=device, runtime=runtime, bad=bad)


def phase_copy_kernels(scrub):
    """Phase 6: K5a, K5b, K6 against their plain versions (bitwise) at
    full width on both block axes, m = 8 and 256 with padding and a WAR
    pair, WAR chains of depth 4 (one pool, and K5b on one tensor), one call
    above the launch parameters' room, and unaligned-page pools; timings,
    K5a's host stages and a profile of one call."""
    from repro_torch.kernels import fpm_copy as fc
    from repro_torch.kernels import ops
    phase_schedule()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rng = np.random.default_rng(SEED + 3)
    page_bytes = 64 * 8 * 128 * 2
    shapes = {0: (FLAT_NBLK, 64, 8, 128),
              1: (28, MAX_SEQS * MAX_BLOCKS_PER_SEQ, 64, 8, 128)}
    pools = {ba: (_bf16_pool(shp, gen), _bf16_pool(shp, gen))
             for ba, shp in shapes.items()}
    counters = ops.KERNEL_COUNTERS
    rows = {}

    def held(name, fn, pool, what, fresh=torch.clone):
        """fn(pool, use_kernel) through the kernel against the plain
        version on copies (``fresh``) of ``pool``, bitwise, and ONE launch
        of the kernel."""
        want = fn(fresh(pool), False)
        before = counters[name].n
        got = fn(fresh(pool), True)
        torch.cuda.synchronize()
        if not _bitwise_equal(got, want):
            raise AssertionError(f"{name} differs from its plain version "
                                 f"({what})")
        if counters[name].n - before != 1:
            raise AssertionError(f"{name}: {counters[name].n - before} "
                                 f"launches ({what})")

    for ba, (a, b) in pools.items():
        nblk = a.shape[ba]
        L = a.shape[0] if ba == 1 else 1
        for m in (8, MAX_REQUESTS):
            ids = _copy_ids(rng, nblk, m)
            xids = _copy_ids(rng, nblk, m, n_src=nblk)
            zids = ids[:, 1].copy()
            live = ids[ids[:, 1] >= 0]
            xlive = xids[xids[:, 1] >= 0]
            t_src, t_dst = (torch.from_numpy(live[:, i].astype(np.int64))
                            .cuda() for i in (0, 1))
            x_src, x_dst = (torch.from_numpy(xlive[:, i].astype(np.int64))
                            .cuda() for i in (0, 1))
            calls = {
                "fpm_copy": (
                    lambda p, k: ops.fpm_copy(p, ids, block_axis=ba,
                                              use_kernel=k),
                    lambda p: p.index_copy_(ba, t_dst,
                                            p.index_select(ba, t_src)), 2),
                "fpm_copy_cross": (
                    lambda p, k: ops.fpm_copy_cross(p, b, xids,
                                                    block_axis=ba,
                                                    use_kernel=k),
                    lambda p: p.index_copy_(ba, x_dst,
                                            b.index_select(ba, x_src)), 2),
                "zero_init": (
                    lambda p, k: ops.meminit_zero(p, zids, block_axis=ba,
                                                  use_kernel=k),
                    lambda p: p.index_fill_(ba, t_dst, 0), 1),
            }
            for name, (fn, lib, passes) in calls.items():
                held(name, fn, a, f"axis {ba}, m={m}")
                out = fc.last_out.tolist()
                ms = time_ms(lambda: fn(a, True), scrub=scrub)
                plain_ms = time_ms(lambda: fn(a, False), reps=5,
                                   scrub=scrub)
                lib_ms = time_ms(lambda: lib(a), scrub=scrub)
                dev, _ = device_ms(lambda: fn(a, True), key="move_kernel")
                nbytes = cost.block_move_bytes(m, L, page_bytes, passes)
                bound = nbytes / cost.HBM_BYTES_PER_S * 1e3
                log(f"[{name}] axis {ba} m={m}: bitwise equal to plain "
                    f"(padding, WAR pair), 1 launch (chunk {out[5]} B, "
                    f"{out[3]} items, grid {out[4]}, {out[6]} waves, bulk "
                    f"{out[7]}); kernel {ms:.4f} ms (device only "
                    f"{_fmt_ms(dev)}), plain {plain_ms:.4f} ms, library "
                    f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({nbytes} "
                    "bytes)")
                rows[(name, ba, m)] = dict(ms=ms, device_ms=dev,
                                           plain_ms=plain_ms,
                                           library_ms=lib_ms,
                                           bound_ms=bound)
            if ba == 0 and m == MAX_REQUESTS:
                st = _block_move_stages(a, ids, scrub)
                log("[fpm_copy] axis 0 m=256 host ms per call (median of "
                    "20): " + ", ".join(f"{k} {v:.4f}"
                                        for k, v in st.items()))
                trace = _profile_one_call(
                    lambda: ops.fpm_copy(a, ids, use_kernel=True))
                ztrace = _profile_one_call(
                    lambda: ops.meminit_zero(a, zids, use_kernel=True))
                for what, tr in (("fpm_copy", trace), ("zero_init", ztrace)):
                    log(f"[{what}] profile of one m=256 call: device "
                        f"events {tr['device']}, runtime calls "
                        f"{tr['runtime']}; host-to-device copies or pinned "
                        f"allocations: {tr['bad'] or 'none'}")
                    if tr["bad"]:
                        raise AssertionError(f"{what} copied to the device "
                                             f"or pinned memory: {tr['bad']}")
        # WAR chains of depth 4 (4 waves) within one pool, K5a and K5b on
        # one tensor
        chain = _chain_ids(rng, nblk, 64, 4)
        held("fpm_copy", lambda p, k: ops.fpm_copy(
            p, chain, block_axis=ba, use_kernel=k), a,
            f"axis {ba}, 64 chains of depth 4")
        waves = int(fc.last_out[6])
        held("fpm_copy_cross", lambda p, k: ops.fpm_copy_cross(
            p, p, chain, block_axis=ba, use_kernel=k), a,
            f"axis {ba}, one pool, chains")
        # the pool-to-pool copy within ONE pool with phase 6's WAR pair
        ids = _copy_ids(rng, nblk, 8)
        held("fpm_copy_cross", lambda p, k: ops.fpm_copy_cross(
            p, p, ids, block_axis=ba, use_kernel=k), a, f"axis {ba}, one pool")
        log(f"[fpm_copy] axis {ba}: 64 WAR chains of depth 4 ({waves} "
            "waves) bitwise equal to plain, K5a and K5b on one tensor, one "
            "launch each")
    # above the launch parameters' room: the rows go through device memory
    a = pools[0][0]
    big = np.stack([np.arange(1000), np.arange(1000, 2000)], 1)[
        rng.permutation(1000)].astype(np.int32)
    held("fpm_copy", lambda p, k: ops.fpm_copy(p, big, use_kernel=k), a,
         f"{len(big)} rows, above {fc.ROW_CAPACITY}")
    held("zero_init", lambda p, k: ops.meminit_zero(
        p, big[:, 1].copy(), use_kernel=k), a, "1000 ids")
    log(f"[fpm_copy] {len(big)} live rows (above the parameters' "
        f"{fc.ROW_CAPACITY}): bitwise equal to plain, one launch each for "
        "K5a and K6")
    # unaligned pages (the word loop) at the CPU tests' dtypes, and an
    # aligned page size on a base 4 bytes off
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        p = torch.randn((4096, 3, 17), generator=gen, device="cuda")
        p = (p * 100).to(dtype)
        ids = _copy_ids(rng, 4096, MAX_REQUESTS)
        for name, fn in (("fpm_copy", lambda q, k: ops.fpm_copy(
                              q, ids, use_kernel=k)),
                         ("zero_init", lambda q, k: ops.meminit_zero(
                             q, ids[:, 1].copy(), use_kernel=k))):
            held(name, fn, p, f"{dtype} pages of {p[0].nbytes} bytes")
            if fc.last_out[7]:
                raise AssertionError("an unaligned page took the bulk path")
    off = torch.randn((4096, 8, 128), generator=gen, device="cuda")
    ids = _copy_ids(rng, 4096, MAX_REQUESTS)
    held("fpm_copy", lambda q, k: ops.fpm_copy(q, ids, use_kernel=k), off,
         "base 4 bytes off", fresh=_offset_copy)
    if fc.last_out[7]:
        raise AssertionError("a base 4 bytes off took the bulk path")
    log("[fpm_copy] unaligned pages (float32 / bfloat16 / int32, 204 / "
        "102 / 204 bytes) and a base 4 bytes off: K5a and K6 bitwise equal "
        "to plain through the word loop")
    del off
    sources = {"fpm_copy": ("fpm_copy.cu", "src/repro/kernels/fpm_copy.py:60"),
               "fpm_copy_cross": ("fpm_copy.cu",
                                  "src/repro/kernels/fpm_copy.py:101"),
               "zero_init": ("zero_init.cu",
                             "src/repro/kernels/zero_init.py:46")}
    out = []
    for name, (src, replaces) in sources.items():
        r = rows[(name, 0, MAX_REQUESTS)]
        out.append(dict(name=name, source=f"src/repro_torch/csrc/{src}",
                        replaces=replaces, max_abs_err=0.0,
                        bound_by="bytes", **r))
    return out, pools[0][0]


def ab_engine(k, v, stage, use_fused: bool):
    """Phase 7's engine (also ``chip_ab.py``'s ``k1`` row) over copies of
    the flat pools ``k``, ``v`` and the two staging pools ``stage``: the
    fused drain, or the fan-out."""
    from repro_torch.core.allocator import SubarrayAllocator
    from repro_torch.core.rowclone import RowCloneEngine
    pools = {"k": k.clone(), "v": v.clone(), "k_stage": stage[0].clone(),
             "v_stage": stage[1].clone()}
    return RowCloneEngine(pools, SubarrayAllocator(FLAT_NBLK, 4),
                          use_fused=use_fused,
                          staging={"k_stage": "k", "v_stage": "v"})


def _fused_flush_stages(eng, rows, scrub, reps: int = 20) -> dict:
    """The host work of one fused flush of ``rows`` (one chunk), stage by
    stage on the host clock (median of ``reps``, each behind a queued
    ``scrub`` fill): the WAR spacing (``space_war_rows``), the padded table
    and the written-pool set (``_touched_pools``), ``ops.fused_dispatch``,
    and one whole ``_drain_rows``."""
    from repro_torch.core.cmdqueue import bucket_size, space_war_rows
    from repro_torch.core.opcodes import OP_NOP
    from repro_torch.kernels import ops
    g = eng.group
    names = ("space_war_rows", "table_and_touched_pools", "fused_dispatch",
             "drain_rows")
    times = {k: [] for k in names}
    for _ in range(reps):
        scrub.zero_()
        t0 = time.perf_counter()
        spaced = space_war_rows([(int(op), int(s), int(d))
                                 for op, s, d in rows], g.locate, g.primary,
                                g.total_blocks)
        t1 = time.perf_counter()
        table = np.full((bucket_size(len(spaced)), 3), OP_NOP, np.int32)
        table[:len(spaced)] = np.asarray(spaced, np.int32)
        eng._touched_pools([tuple(r) for r in table.tolist() if r[0] >= 0])
        t2 = time.perf_counter()
        ops.fused_dispatch(tuple(eng.pools.values()), eng._get_zero_blocks(),
                           table, block_axis=eng.block_axis,
                           primary=g.primary)
        t3 = time.perf_counter()
        scrub.zero_()
        t4 = time.perf_counter()
        eng._drain_rows(rows)
        t5 = time.perf_counter()
        torch.cuda.synchronize()
        for k, a, b in zip(names, (t0, t1, t2, t4), (t1, t2, t3, t5)):
            times[k].append((b - a) * 1e3)
    return {k: float(np.median(v)) for k, v in times.items()}


def phase_ab(flat, scrub):
    """Phase 7: the fused drain against the fan-out over identical pools.
    Returns the launch counts of the fan-out run (the copy kernels' main
    path) and of the fused run (K1's)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import mechanisms
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    v = _bf16_pool(flat.shape, gen)
    stage = [_bf16_pool((64,) + tuple(flat.shape[1:]), gen)
             for _ in range(2)]
    prog = mechanisms.ab_program(FLAT_NBLK)
    fanout, fused = ab_engine(flat, v, stage, False), \
        ab_engine(flat, v, stage, True)
    counters = ops.KERNEL_COUNTERS
    for c in counters.values():
        c.reset()
    torch.cuda.synchronize()
    mechanisms.drive(fanout, prog)
    torch.cuda.synchronize()
    launches = {n: c.n for n, c in counters.items()}
    for c in counters.values():
        c.reset()
    mechanisms.drive(fused, prog)
    torch.cuda.synchronize()
    fused_launches = {n: c.n for n, c in counters.items()}
    bad = [n for n in fused.pools
           if not _bitwise_equal(fused.pools[n], fanout.pools[n])]
    rows = fused.journal.records[-1].rows
    n_live = sum(1 for r in rows if r[0] >= 0)
    n_fused, n_fanout = fused.stats.launches, fanout.stats.launches
    checks = {
        "pools bitwise equal": not bad,
        "fused: 1 launch per flush": n_fused == 1
        and fused_launches["fused_dispatch"] == 1,
        "fan-out launches == CPU-pinned count":
            n_fanout == mechanisms.AB_FANOUT_LAUNCHES,
        "same table": fanout.journal.records[-1].rows == rows,
        "K5a, K5b, K6 launched": all(launches[k] > 0 for k in (
            "fpm_copy", "fpm_copy_cross", "zero_init")),
        "no fused launch on the fan-out": launches["fused_dispatch"] == 0,
    }
    # ms per flush: re-drain the same table, in turns
    times = {True: [], False: []}
    for use_fused in (True, False, False, True, True, False):
        eng = fused if use_fused else fanout
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._drain_rows(rows)
        torch.cuda.synchronize()
        times[use_fused].append((time.perf_counter() - t0) * 1e3)
    card = {f: time_ms(lambda: e._drain_rows(rows), reps=3)
            for f, e in ((True, fused), (False, fanout))}
    k1_dev, _ = device_ms(lambda: fused._drain_rows(rows),
                          key="drain_kernel", reps=3)
    log(f"[A/B] card time per flush (CUDA events): fused "
        f"{card[True]:.4f} ms (K1 device {_fmt_ms(k1_dev)}), fan-out "
        f"{card[False]:.4f} ms")
    from repro_torch.kernels import fused_dispatch as fd
    table = np.asarray([r for r in rows if r[0] >= 0], np.int32)
    sizes = [int(p.shape[fused.block_axis]) for p in fused.pools.values()]
    bound = cost.k1_bytes(table, sizes, fused.group.primary, 1,
                          flat[0].nbytes) / cost.HBM_BYTES_PER_S * 1e3
    ms = time_ms(lambda: fused._drain_rows(rows), scrub=scrub)
    log(f"[A/B] fused flush of {n_live} rows: card {ms:.4f} ms (CUDA "
        f"events around _drain_rows), K1 device {_fmt_ms(k1_dev)}, bound "
        f"{bound:.4f} ms")
    st = _fused_flush_stages(fused, rows, scrub)
    log("[A/B] fused flush host ms (median of 20): " + ", ".join(
        f"{k} {v:.4f}" for k, v in st.items()))
    pools = tuple(fused.pools.values())
    st = _k1_host_stages(pools, table, fused.group.primary,
                         fused.block_axis, scrub)
    log(f"[A/B] K1 wrapper host ms on the {len(table)}-row table ("
        f"{int(fd.last_out[1])} moves, median of 20): " + ", ".join(
            f"{k} {v:.4f}" for k, v in st.items()))
    log(f"[A/B] {n_live} rows in one flush: fused {n_fused} "
        f"launch, fan-out {n_fanout} launches (pinned "
        f"{mechanisms.AB_FANOUT_LAUNCHES}); ms per flush (host clock, "
        f"synchronised, median of 3): fused "
        f"{float(np.median(times[True])):.3f}, fan-out "
        f"{float(np.median(times[False])):.3f}; pools bitwise equal: "
        f"{not bad}")
    log("[A/B] launch counters, fan-out run: " + " ".join(
        f"{k}={launches[k]}" for k in ("fused_dispatch", "fpm_copy",
                                       "fpm_copy_cross", "zero_init"))
        + "; fused run: " + " ".join(
        f"{k}={fused_launches[k]}" for k in ("fused_dispatch", "fpm_copy",
                                             "fpm_copy_cross",
                                             "zero_init")))
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"A/B checks failed: {failed} (pools {bad})")
    return launches, fused_launches


def phase_table1(flat):
    """Phase 8a: Table 1 on a phase-6 pool."""
    from repro_torch.launch import mechanisms
    for m in (8, MAX_REQUESTS):
        for r in mechanisms.run(pool=flat, m=m):
            log("[table1] " + json.dumps(r))


def phase_fig2(cfg, params):
    """Phase 8b: Fig. 2 at full width, RowClone off and on (the
    ``checkpoint`` application trains yi-6b reduced on the card, as the
    reference).  Returns the launch counts of the run (K1's fused
    drains)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import applications
    for c in ops.KERNEL_COUNTERS.values():
        c.reset()
    torch.cuda.synchronize()
    rows = applications.run(cfg, params, device="cuda")
    torch.cuda.synchronize()
    launches = {n: c.n for n, c in ops.KERNEL_COUNTERS.items()}
    for r in rows:
        log("[fig2] " + json.dumps(r))
    by = {(r["app"], r["rowclone"]): r for r in rows}
    checks = {
        "forkbench: on moves by FPM what off moves through compute":
            by[("forkbench", "on")]["bytes_dma"]
            == by[("forkbench", "off")]["bytes_compute"] > 0,
        "forkbench: 30 tokens": by[("forkbench", "on")]["tokens"] == 30,
        "buz-init: 24 blocks lazily zeroed on, materialised off":
            by[("buz-init", "on")]["zero_lazy"] == 24
            and by[("buz-init", "off")]["zero_mat"] == 24,
        "migrate: on moves by PSM what off moves through compute":
            by[("migrate", "on")]["bytes_ici"]
            == by[("migrate", "off")]["bytes_compute"] > 0,
        "checkpoint: 4 checkpoints of yi-6b reduced, blocking off and async"
        " on": by[("checkpoint", "off")]["checkpoints"]
            == by[("checkpoint", "on")]["checkpoints"] == 4,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"Fig-2 checks failed: {failed}")
    log("[fig2] launch counters: " + " ".join(
        f"{k}={v}" for k, v in launches.items() if v))
    return launches


# ---------------------------------------------------------------------------
# phases 9-11: the Mamba2 families (ssm, hybrid)
# ---------------------------------------------------------------------------

#: K4: both sides accumulate in fp32 in different orders; the error is
#: held relative to the output's scale
K4_RTOL = 1e-3
#: (config, chunk rows Bc, Q, SSD heads H, state N) of phase 9: the chunk
#: rows of phase 10/11's batch prefill (4 prompts x 2 chunks) and the
#: ragged single chunks of a 250- and a 96-token prompt
K4_CASES = (("mamba2-780m", 8, 256, 48, 128), ("zamba2-2.7b", 8, 256, 80, 64),
            ("mamba2-780m", 1, 250, 48, 128), ("mamba2-780m", 1, 96, 48, 128),
            ("zamba2-2.7b", 1, 250, 80, 64))
#: K4 edge cases (Q, H, N, dtype of x / B / C) on 2 chunk rows: partial head
#: groups (H = 5 and 3 for a kernel that takes two heads per CTA), state
#: sizes 32 and 256, ragged Q = 96 and 250, and fp32 inputs
K4_EDGES = ((256, 6, 32, torch.bfloat16), (96, 6, 32, torch.bfloat16),
            (250, 6, 32, torch.float32), (256, 8, 128, torch.bfloat16),
            (256, 5, 64, torch.bfloat16), (250, 3, 256, torch.bfloat16))
#: phase 10/11: a batch of 4 prompts of 384 tokens (2 chunks of 256), one
#: prompt of 250 (one ragged chunk), greedy decode steps on the batch
SSM_BATCH, SSM_PROMPT, SSM_RAGGED, SSM_STEPS = 4, 384, 250, 16


def _ssd_inputs(gen, Bc, Q, H, N, P=64):
    """Chunk inputs as the model passes them: bf16 x / B / C, fp32 dt
    (log-uniform in [1e-3, 1e-1], the init range) and its in-chunk cumsum
    with A = -(1..H)."""
    x = torch.randn((Bc, Q, H, P), generator=gen, device="cuda").bfloat16()
    u = torch.rand((Bc, Q, H), generator=gen, device="cuda")
    dt = torch.exp(np.log(1e-3) + u * (np.log(1e-1) - np.log(1e-3)))
    A = -torch.arange(1, H + 1, dtype=torch.float32, device="cuda")
    cum = torch.cumsum(dt * A, dim=1)
    Bm = torch.randn((Bc, Q, N), generator=gen, device="cuda").bfloat16()
    Cm = torch.randn((Bc, Q, N), generator=gen, device="cuda").bfloat16()
    return x, dt.contiguous(), cum.contiguous(), Bm, Cm


def phase_k4(scrub):
    """Phase 9a: K4 against its plain version at the models' shapes."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    edge = []
    for Q, H, N, dtype in K4_EDGES:
        x, dt, cum, Bm, Cm = _ssd_inputs(gen, 2, Q, H, N)
        x, Bm, Cm = (t.to(dtype) for t in (x, Bm, Cm))
        got = ops.ssd_intra_chunk(x, dt, cum, Bm, Cm, use_kernel=True)
        want = ops.ssd_intra_chunk(x, dt, cum, Bm, Cm, use_kernel=False)
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        edge.append(err)
        if not (bool(torch.isfinite(got).all()) and err <= K4_RTOL * scale):
            raise AssertionError(f"K4 vs plain at Q={Q} H={H} N={N} {dtype}:"
                                 f" max err {err} vs {K4_RTOL} x {scale}")
    log(f"[K4] edge cases (Q, H, N, dtype) on 2 chunk rows: "
        + ", ".join(f"({Q}, {H}, {N}, {str(d)[6:]}) {e:.2e}"
                    for (Q, H, N, d), e in zip(K4_EDGES, edge))
        + f" (each within {K4_RTOL} x max |plain|)")
    rows = {}
    for arch, Bc, Q, H, N in K4_CASES:
        args = _ssd_inputs(gen, Bc, Q, H, N)
        got = ops.ssd_intra_chunk(*args, use_kernel=True)
        want = ops.ssd_intra_chunk(*args, use_kernel=False)
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        finite = bool(torch.isfinite(got).all())
        if not (finite and err <= K4_RTOL * scale):
            raise AssertionError(f"K4 vs plain ({arch} Bc={Bc} Q={Q}): max "
                                 f"err {err} vs {K4_RTOL} x {scale}, finite "
                                 f"{finite}")
        ms = time_ms(lambda: ops.ssd_intra_chunk(*args, use_kernel=True),
                     scrub=scrub)
        dev, _ = device_ms(lambda: ops.ssd_intra_chunk(*args,
                                                       use_kernel=True),
                           key="ssd_intra")
        plain_ms = time_ms(lambda: ops.ssd_intra_chunk(*args,
                                                       use_kernel=False),
                           reps=5, scrub=scrub)
        nbytes, flops = cost.k4_work(*args)
        b_bytes = nbytes / cost.HBM_BYTES_PER_S * 1e3
        b_ops = flops / cost.BF16_FLOPS * 1e3
        bound = max(b_bytes, b_ops)
        log(f"[K4] {arch} Bc={Bc} Q={Q} H={H} N={N}: max err {err:.3e} "
            f"(limit {K4_RTOL} x max |plain| {scale:.3e}); kernel "
            f"{ms:.4f} ms (device only {_fmt_ms(dev)}), plain "
            f"{plain_ms:.4f} ms, bound {bound:.5f} ms ({nbytes} bytes -> "
            f"{b_bytes:.5f} ms, {flops:.4e} flop -> {b_ops:.5f} ms)")
        rows[(arch, Bc, Q)] = dict(err=err / scale, ms=ms, dev=dev,
                                   plain_ms=plain_ms, bound=bound,
                                   by="bytes" if b_bytes >= b_ops
                                   else "operations", abs_err=err)
        del args, got, want
    r = rows[("mamba2-780m", 8, 256)]
    return dict(name="ssd_intra_chunk",
                source="src/repro_torch/csrc/ssd_chunk.cu",
                replaces="src/repro/kernels/ssd_chunk.py:47",
                max_abs_err=max([x["abs_err"] for x in rows.values()]
                                + edge),
                ms=r["ms"], device_ms=r["dev"], plain_ms=r["plain_ms"],
                bound_ms=r["bound"], bound_by=r["by"], library_ms=None)


def hybrid_faults() -> dict:
    """Planted faults in the plain K2 / K3 that phase 11's per-call check
    must catch, each a slip a head-dim-128 or single-batch kernel could make at
    zamba2's shapes: {fault: (ops name, replacement)}."""
    from repro_torch.kernels import ref
    shrink = (80 / 128) ** 0.5          # leaves the softmax scale at 128's

    def scaled(q):
        return (q.float() * shrink).to(q.dtype)

    def k3_scale(q, k, v, *, use_kernel=None, **kw):
        return ref.flash_attention(scaled(q), k, v, **kw)

    def k3_batch0(q, k, v, *, use_kernel=None, **kw):
        return ref.flash_attention(q, k[:1].expand_as(k), v[:1].expand_as(v),
                                   **kw)

    def k2_scale(q, k, v, share_mask, base, seq_lens, *, page,
                 use_kernel=None):
        return ref.paged_attention_slab(scaled(q), k, v, share_mask, base,
                                        seq_lens, page=page)

    def k2_drop_newest(q, k, v, share_mask, base, seq_lens, *, page,
                       use_kernel=None):
        return ref.paged_attention_slab(q, k, v, share_mask, base,
                                        seq_lens - 1, page=page)

    return {"K3 softmax scale 1/sqrt(128)": ("flash_attention", k3_scale),
            "K3 reads batch row 0's K/V": ("flash_attention", k3_batch0),
            "K2 softmax scale 1/sqrt(128)": ("paged_attention_slab",
                                             k2_scale),
            "K2 misses the newest token": ("paged_attention_slab",
                                           k2_drop_newest)}


#: the kernels of the Mamba2 families' path, held call by call
TAPPED = ("ssd_intra_chunk", "flash_attention", "paged_attention_slab")


def _call_reading(op, got, want):
    """(max |diff|, limit) of one call's result against its plain version,
    with phase 9's tolerances."""
    if op == "paged_attention_slab":
        (acc, l, m), (acc_p, l_p, m_p) = got, want
        out = acc / l.clamp_min(1e-30)[..., None]
        out_p = acc_p / l_p.clamp_min(1e-30)[..., None]
        return max(float((out - out_p).abs().max()),
                   float((m - m_p).abs().max())), K2_ATOL
    err = float((got.float() - want.float()).abs().max())
    if op == "flash_attention":
        return err, K3_ATOL
    return err, K4_RTOL * float(want.abs().max())


def tapped(run, fault=None):
    """Call ``run()`` with every K2 / K3 / K4 call held against its plain
    version on the same inputs; ``fault`` = (op, fn) puts a planted fault
    in place of that op's kernel.  K3's plain version takes the call's
    bf16 inputs as fp32, so that it returns the attention before the bf16
    rounding: two correct bf16 results can lie one ulp apart (3.1e-2 at
    |x| >= 4, above ``K3_ATOL``), one correct result lies within half an
    ulp of the fp32 one.  Returns run()'s result and, per op called, the
    number of calls and the reading (max |diff| and its limit) of the call
    nearest its limit.  Its launches come after the counted run and are
    not part of it."""
    from repro_torch.kernels import ops
    saved = {op: getattr(ops, op) for op in TAPPED}
    reads = {}

    def wrap(op):
        def call(*args, use_kernel=None, **kw):
            if fault is not None and fault[0] == op:
                got = fault[1](*args, **kw)
            else:
                got = saved[op](*args, use_kernel=True, **kw)
            plain_args = [a.float() for a in args] \
                if op == "flash_attention" else args
            err, limit = _call_reading(
                op, got, saved[op](*plain_args, use_kernel=False, **kw))
            r = reads.setdefault(op, dict(calls=0, err=0.0, limit=limit))
            r["calls"] += 1
            if err / limit >= r["err"] / r["limit"]:
                r.update(err=err, limit=limit)
            return got
        return call

    for op in TAPPED:
        setattr(ops, op, wrap(op))
    try:
        out = run()
    finally:
        for op, fn in saved.items():
            setattr(ops, op, fn)
    return out, reads


def _fmt_reads(reads) -> str:
    return ", ".join(f"{op} {r['calls']} calls, max |diff| {r['err']:.3e} "
                     f"(limit {r['limit']:.3e})" for op, r in reads.items())


def _state_bytes(state) -> int:
    return sum(t.numel() * t.element_size() for t in state.values())


def phase_mamba_model(arch: str) -> dict:
    """Phases 10 (mamba2-780m) and 11 (zamba2-2.7b): full width, random
    weights from seed 0.  Prefill a batch of 4 x 384 tokens and one
    250-token prompt, then 16 greedy decode steps on the batch; check the
    launch counts, finite logits, and the prefill and first-step logits
    against the same calls through the plain versions.  Returns the launch
    counts of the counted run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.weights import init_params
    cfg = get_config(arch)
    t0 = time.perf_counter()
    model = init_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    tag = arch
    log(f"[{tag}] {cfg.family}: {cfg.num_layers} Mamba2 layers, d_model "
        f"{cfg.d_model}, {cfg.ssm_heads} SSD heads x {cfg.ssm_head_dim}, "
        f"N {cfg.ssm_state}, {cfg.num_attn_layers} shared-attention calls; "
        f"{n_params / 1e9:.3f} B params ({n_bytes / 1e9:.2f} GB), init "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    batch = torch.from_numpy(rng.integers(
        2, cfg.vocab_size, (SSM_BATCH, SSM_PROMPT))).cuda()
    single = torch.from_numpy(rng.integers(
        2, cfg.vocab_size, (1, SSM_RAGGED))).cuda()
    L, n_attn = cfg.num_layers, cfg.num_attn_layers
    counters = ops.KERNEL_COUNTERS

    def counts():
        return {n: c.n for n, c in counters.items()}

    for c in counters.values():
        c.reset()
    torch.cuda.synchronize()
    total = {n: 0 for n in counters}
    checks = {}
    out = {}
    for name, tokens in (("batch", batch), ("ragged", single)):
        before = counts()
        t = time.perf_counter()
        logits, state = model.prefill_state(tokens)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        got = {n: counts()[n] - before[n] for n in counters}
        checks[f"{name} prefill: K4 == layers"] = \
            got["ssd_intra_chunk"] == L
        checks[f"{name} prefill: K3 == shared-attention calls"] = \
            got["flash_attention"] == n_attn
        checks[f"{name} prefill logits finite"] = \
            bool(torch.isfinite(logits).all())
        out[name] = (logits, state, ms)
        log(f"[{tag}] prefill {tuple(tokens.shape)}: {ms:.1f} ms "
            f"(host clock, synchronised), K4 {got['ssd_intra_chunk']}, K3 "
            f"{got['flash_attention']} launches; state "
            f"{_state_bytes(state) / 1e6:.1f} MB")
    logits, state, _ = out["batch"]
    prefill_logits, ragged_logits = logits, out["ragged"][0]
    tok = logits.argmax(-1)
    step_ms, per_step, first = [], [], None
    for step in range(SSM_STEPS):
        before = counts()
        t = time.perf_counter()
        logits, state = model.decode_state(state, tok)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        per_step.append({n: counts()[n] - before[n] for n in counters})
        if step == 0:
            first = (tok.clone(), logits.clone())
        tok = logits.argmax(-1)
    launches = counts()
    checks["decode: K2 == shared-attention calls per step"] = all(
        g["paged_attention"] == n_attn for g in per_step)
    checks["decode: no K4 / K3"] = all(
        g["ssd_intra_chunk"] == 0 and g["flash_attention"] == 0
        for g in per_step)
    checks["decode logits finite"] = bool(torch.isfinite(logits).all())
    med = float(np.median(step_ms[1:]))
    log(f"[{tag}] {SSM_STEPS} greedy decode steps on {SSM_BATCH} sequences: "
        f"median {med:.2f} ms/step (steps 2-{SSM_STEPS}), "
        f"{SSM_BATCH * SSM_STEPS / (sum(step_ms) / 1e3):.1f} tokens/s over "
        f"all steps; state {_state_bytes(state) / 1e6:.1f} MB "
        f"(seq_lens {int(state['seq_lens'][0])})")
    log(f"[{tag}] launches (counted run: 2 prefills + {SSM_STEPS} steps): "
        + " ".join(f"{k}={launches[k]}" for k in
                   ("ssd_intra_chunk", "flash_attention", "paged_attention",
                    "fused_dispatch")))
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{arch} checks failed: {failed}")
    profile_rounds(lambda: model.decode_state(state, tok), tag=tag,
                   what="step")
    profile_rounds(lambda: model.prefill_state(batch), rounds=2, tag=tag,
                   what="prefill")
    del state, out

    # the same calls through the plain versions
    with ops.plain_versions():
        p_batch, p_state = model.prefill_state(batch)
        p_single, _ = model.prefill_state(single)
        p_step, _ = model.decode_state(p_state, first[0])
    torch.cuda.synchronize()
    for what, a, b in (("batch prefill", prefill_logits, p_batch),
                       ("ragged prefill", ragged_logits, p_single),
                       ("first decode step", first[1], p_step)):
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        agree = int((a.argmax(-1) == b.argmax(-1)).sum())
        log(f"[{tag}] {what} logits vs plain versions: max |diff| "
            f"{err:.3e} (limit {SERVE_RTOL} x max |logit| = "
            f"{SERVE_RTOL * scale:.3e}); argmax agrees on "
            f"{agree}/{a.shape[0]}")
        if not err <= SERVE_RTOL * scale:
            raise AssertionError(f"{arch} {what} logits differ from the "
                                 "plain versions")
    # every kernel call of the path against its plain version on the same
    # inputs (the limit above cannot tell a subtle K2 / K3 fault from the
    # bf16 drift of 54 random layers), then the planted faults in its place
    def path():
        b_logits, st = model.prefill_state(batch)
        model.prefill_state(single)
        s_logits, _ = model.decode_state(st, first[0])
        return b_logits, s_logits

    _, reads = tapped(path)
    log(f"[{tag}] every kernel call vs its plain version on the same "
        "inputs: " + _fmt_reads(reads))
    if any(r["err"] > r["limit"] for r in reads.values()):
        raise AssertionError(f"{arch}: a kernel call differs from its plain "
                             f"version: {reads}")
    faults = hybrid_faults() if cfg.family == "hybrid" else {}
    for fault, (op, fn) in faults.items():
        (f_batch, f_step), reads = tapped(path, fault=(op, fn))
        e2e = [(float((f - p).abs().max()), SERVE_RTOL * float(p.abs().max()))
               for f, p in ((f_batch, p_batch), (f_step, p_step))]
        caught = reads[op]["err"] > reads[op]["limit"]
        log(f"[{tag}] planted fault '{fault}': per call {_fmt_reads(reads)};"
            f" logits vs plain {e2e[0][0]:.3e} (batch prefill, limit "
            f"{e2e[0][1]:.3e}), {e2e[1][0]:.3e} (first step, limit "
            f"{e2e[1][1]:.3e}); caught per call: {caught}")
        if not caught:
            raise AssertionError(f"{arch}: the per-call check misses the "
                                 f"planted fault '{fault}'")
    del model
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phases 12-13: the moe family and the other dense configs, served
# ---------------------------------------------------------------------------

#: phase 13: (config, layers kept, None for full depth) — qwen2-72b (145 GB
#: of weights) and phi3.5-moe-42b-a6.6b (84 GB) are cut in depth to fit the
#: card; their widths stay the published ones
OTHER_CONFIGS = (("yi-6b", None), ("mistral-nemo-12b", None),
                 ("qwen2-72b", 16), ("phi3.5-moe-42b-a6.6b", 8))
#: phase 13's short protocol: two prompts, a fork of the first before
#: round 2, 4 rounds
SHORT_PROMPT_LENS, SHORT_ROUNDS = (250, 512), 4
#: scale of the QKV biases drawn for qwen2-72b: zero at init, as the
#: reference's, and drawn here so that the bias add runs on real data
QKV_BIAS_SCALE = 0.5


def _draw_qkv_bias(model, seed: int) -> None:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for layer in model.layers:
        for name in ("bq", "bk", "bv"):
            p = getattr(layer, name)
            p.data.copy_(torch.randn(p.shape, generator=gen, device="cuda")
                         * QKV_BIAS_SCALE)


def phase_decoder_serve(arch: str, layers=None, prompt_lens=PROMPT_LENS,
                        rounds: int = ROUNDS, profile: bool = False):
    """Phases 5, 12 and 13: serve ``arch`` at full width (``layers`` of its
    layers when cut in depth) with random weights from seed 0 (qwen2-72b's
    QKV biases drawn nonzero): admit ``prompt_lens``, one round, fork the
    first sequence into 2 before round 2, ``rounds`` rounds in all.
    Checks K1 <= 1 launch per round (1 in a round with bulk work), K2 ==
    layers per round, K3 == layers per admission, the allocated parameters
    against ``param_count()``, finite logits, the first round's logits
    against the same admissions and round through the plain versions (fed
    the same round-1 tokens; for moe the routing flips between the two
    runs are counted, and if the logits differ with flips the plain run
    replays the kernel run's routing), then every K2 and K3 call of the
    admissions and the first round against its plain version on the same
    inputs.  ``profile``: profiles of three steady rounds and of the
    admissions into a fresh engine.  Returns the launch counts of the
    counted run and the model."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import ServingEngine
    from repro_torch.models import moe
    from repro_torch.weights import init_params
    full = get_config(arch)
    cfg = full if layers is None else dataclasses.replace(full,
                                                          num_layers=layers)
    cut = "full depth" if layers is None else \
        f"depth cut: {layers} of {full.num_layers} layers"
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, device="cuda")
    if cfg.qkv_bias:
        _draw_qkv_bias(params, SEED + 3)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    experts = (f", {cfg.num_experts} experts top-{cfg.top_k} of d_ff "
               f"{cfg.moe_d_ff or cfg.d_ff} + {cfg.num_shared_experts} "
               "shared" if cfg.family == "moe" else f", d_ff {cfg.d_ff}")
    log(f"[{arch}] {cfg.family}, {cut}: d_model {cfg.d_model}, "
        f"{cfg.num_heads} heads over {cfg.num_kv_heads} KV heads x "
        f"{cfg.head_dim} (group {cfg.num_heads // cfg.num_kv_heads})"
        f"{experts}{', QKV bias' if cfg.qkv_bias else ''}; param_count() "
        f"{full.param_count() / 1e9:.3f} B (active "
        f"{full.active_param_count() / 1e9:.3f} B) at full depth, "
        f"{cfg.param_count() / 1e9:.3f} B (active "
        f"{cfg.active_param_count() / 1e9:.3f} B) as run; allocated "
        f"{n_params / 1e9:.3f} B params ({n_bytes / 1e9:.2f} GB), init "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32)
               for n in prompt_lens]

    def engine():
        return ServingEngine(cfg, params, max_seqs=MAX_SEQS,
                             max_blocks_per_seq=MAX_BLOCKS_PER_SEQ)

    eng = engine()
    page_kib = eng.engine.pools["k"][0, 0].numel() * 2 // 1024
    log(f"[{arch}] pools {eng.pool_bytes_resident() / 1e9:.2f} GB (K/V "
        f"pools {eng.engine.pools['k'].numel() * 2 / 1e9:.2f} GB each; "
        f"{cfg.num_kv_heads} KV heads per page, {page_kib} KiB per page "
        "and layer)")
    routes = moe.RouteLog(cfg.num_experts) if cfg.family == "moe" \
        else None
    counters = ops.KERNEL_COUNTERS
    for c in counters.values():
        c.reset()
    L = cfg.num_layers
    k3_per_admission, sids = [], []
    round_ms, fused, k2_per_round, bulk = [], [], [], []
    n_tokens = 0
    moe.ROUTE_HOOK = routes
    try:
        torch.cuda.synchronize()
        t_admit = time.perf_counter()
        for p in prompts:
            before = counters["flash_attention"].n
            sids.append(eng.add_request(p))
            k3_per_admission.append(counters["flash_attention"].n - before)
        torch.cuda.synchronize()
        t_admit = time.perf_counter() - t_admit
        for rnd in range(rounds):
            if rnd == 1:
                eng.fork(sids[0], 2)
            before = {n: c.n for n, c in counters.items()}
            t = time.perf_counter()
            out = eng.decode_round()
            torch.cuda.synchronize()
            round_ms.append((time.perf_counter() - t) * 1e3)
            n_tokens += len(out)
            fused.append(counters["fused_dispatch"].n -
                         before["fused_dispatch"])
            k2_per_round.append(counters["paged_attention"].n -
                                before["paged_attention"])
            bulk.append(eng.last_ticket.commands > 0)
            if rnd == 0:
                moe.ROUTE_HOOK = None
                first_logits = {s: eng.last_logits[s].copy() for s in sids}
                first_tokens = dict(out)
    finally:
        moe.ROUTE_HOOK = None
    launches = {n: c.n for n, c in counters.items()}
    checks = {
        "allocated parameters == param_count() + the final norm":
            n_params == cfg.param_count() + cfg.d_model,
        "K1 <= 1 per round": max(fused) <= 1,
        "K1 == 1 on every round with bulk work":
            any(bulk) and all(f == 1 for f, b in zip(fused, bulk) if b),
        "K2 == layers per round": all(n == L for n in k2_per_round),
        "K3 == layers per admission":
            all(n == L for n in k3_per_admission),
        "logits finite": all(np.isfinite(lg).all()
                             for lg in eng.last_logits.values()),
    }
    steady = float(np.median(round_ms[2:]))
    log(f"[{arch}] admitted {len(prompts)} prompts {tuple(prompt_lens)} in "
        f"{t_admit * 1e3:.1f} ms; {rounds} rounds, median {steady:.2f} "
        f"ms/round (rounds 3-{rounds}, host clock, synchronised), "
        f"{n_tokens / (sum(round_ms) / 1e3):.1f} tokens/s over all rounds; "
        f"K1 per round {fused}, K2 per round {sorted(set(k2_per_round))}, "
        f"K3 per admission {k3_per_admission}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{arch} serve checks failed: {failed}")
    if profile:
        profile_rounds(eng.decode_round, tag=arch)
    del eng
    torch.cuda.empty_cache()
    if profile:
        # the same admissions into a fresh engine, profiled
        fresh = engine()
        profile_rounds(lambda: _admit_all(fresh, prompts), rounds=1,
                       tag=arch, what="admission")
        del fresh
        torch.cuda.empty_cache()

    # the same admissions and first round through the plain versions, fed
    # the kernel run's round-1 tokens
    def plain_run(mode):
        if routes is not None:
            routes.reset(mode)
        moe.ROUTE_HOOK = routes
        try:
            with ops.plain_versions():
                plain = engine()
                psids = _admit_all(plain, prompts)
                toks = iter([first_tokens[s] for s in sorted(first_tokens)])
                plain.decode_round(sample_fn=lambda _: next(toks))
        finally:
            moe.ROUTE_HOOK = None
        got = [plain.last_logits[ps] for ps in psids]
        del plain
        torch.cuda.empty_cache()
        errs = [float(np.abs(first_logits[s] - b).max())
                for s, b in zip(sids, got)]
        scale = max(float(np.abs(b).max()) for b in got)
        agree = sum(int(np.argmax(first_logits[s]) == np.argmax(b))
                    for s, b in zip(sids, got))
        flips = "" if routes is None else (
            f"; routing flips {routes.flipped()} of {routes.choices} "
            "choices" + (" (the plain run's own choices, replaced by the "
                         "kernel run's)" if mode == "replay" else ""))
        under = " under the kernel run's routing" if mode == "replay" \
            else ""
        log(f"[{arch}] round-1 logits vs plain versions{under}: max |diff| "
            f"{max(errs):.3e} (limit {SERVE_RTOL} x max |logit| = "
            f"{SERVE_RTOL * scale:.3e}); argmax agrees on "
            f"{agree}/{len(sids)}{flips}")
        return max(errs) <= SERVE_RTOL * scale

    ok = plain_run("compare")
    if not ok and routes is not None and routes.flipped():
        ok = plain_run("replay")
    if not ok:
        raise AssertionError(f"{arch} serve logits differ from the plain "
                             "versions")

    # every K2 / K3 call of the admissions and the first round against its
    # plain version on the same inputs (the calls' check of record)
    def path():
        tap = engine()
        _admit_all(tap, prompts)
        tap.decode_round()

    _, reads = tapped(path)
    torch.cuda.empty_cache()
    log(f"[{arch}] every kernel call vs its plain version on the same "
        "inputs: " + _fmt_reads(reads))
    calls = {op: r["calls"] for op, r in reads.items()}
    if calls != {"flash_attention": L * len(prompts),
                 "paged_attention_slab": L} or \
            any(r["err"] > r["limit"] for r in reads.values()):
        raise AssertionError(f"{arch}: kernel calls vs plain: {reads}")
    return launches, params


# ---------------------------------------------------------------------------
# phase 15: the remaining ServingEngine features, llama3.2-3b at full width
# ---------------------------------------------------------------------------

#: phase 15's prompts: 4 of FEAT_PAGES pages, the first FEAT_SHARED pages
#: (the shared prefix) common to all four
FEAT_PAGES, FEAT_SHARED, FEAT_PROMPTS = 8, 6, 4
#: (a) and (d) run FEAT_ROUNDS rounds; (b) demotes the third sequence
#: before round PREEMPT_AT, resumes it before round RESUME_AT and runs to
#: round PREEMPT_ROUNDS
FEAT_ROUNDS, PREEMPT_AT, RESUME_AT, PREEMPT_ROUNDS = 6, 3, 5, 8
#: (b)'s spill slots, (c)'s nominal staging ring
FEAT_SPILL, FEAT_RING = 64, 8


class K1Events:
    """CUDA events around each K1 launch of the serving engine: a drain
    guard records one before the drain's host work, the launch hook one
    right after the launch, so the elapsed time is the call's card ms
    (host work included, as ``time_ms``).  ``round`` tags the calls."""

    def __init__(self):
        self.calls, self.round, self._start = [], None, None

    def _guard(self, info):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self._start = (ev, info.n_commands)

    def _hook(self, n, pools, mech):
        if mech == "fused" and self._start is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.calls.append((self.round, self._start[0], ev,
                               self._start[1]))
            self._start = None

    def __enter__(self):
        from repro_torch.kernels import fused_dispatch as fd
        fd.add_drain_guard(self._guard)
        fd.add_launch_hook(self._hook)
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import fused_dispatch as fd
        fd.remove_drain_guard(self._guard)
        fd.remove_launch_hook(self._hook)

    def by_round(self) -> dict:
        """round -> [(card ms, live rows)] of its K1 launches."""
        torch.cuda.synchronize()
        out = {}
        for rnd, a, b, n in self.calls:
            out.setdefault(rnd, []).append((a.elapsed_time(b), n))
        return out


def _logit_diff(a: dict, b: dict) -> tuple:
    """(max |a - b|, the limit SERVE_RTOL x max |b|, bitwise?) over the
    sequences of two ``last_logits``-like dicts."""
    err = max(float(np.abs(a[s] - b[s]).max()) for s in b)
    scale = max(float(np.abs(x).max()) for x in b.values())
    same = all(np.array_equal(a[s], b[s]) for s in b)
    return err, SERVE_RTOL * scale, same


def _serve_rounds(eng, rounds: int, before_round=None, timer=None):
    """``rounds`` greedy rounds; ``before_round(r)`` runs before round r
    (1-based).  Returns K1 launches per round and every round's
    ``last_logits`` (copies)."""
    from repro_torch.kernels import ops
    k1 = ops.KERNEL_COUNTERS["fused_dispatch"]
    per_round, logits = [], []
    for rnd in range(1, rounds + 1):
        if before_round is not None:
            before_round(rnd)
        if timer is not None:
            timer.round = rnd
        n0 = k1.n
        eng.decode_round()
        per_round.append(k1.n - n0)
        logits.append({s: lg.copy() for s, lg in eng.last_logits.items()})
    torch.cuda.synchronize()
    return per_round, logits


def _timed_admissions(eng, prompts):
    """Admit ``prompts``; returns the sids and each admission's card ms
    (CUDA events around ``add_request``)."""
    sids, ms = [], []
    for p in prompts:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        sids.append(eng.add_request(p))
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    return sids, ms


def phase_serving_features(params, smi: str) -> dict:
    """Phase 15: dedup-on-admit, demote / resume, the double-buffered and
    adaptive staging ring and the ``fused_staging=False`` leg of
    ``ServingEngine``, on phase 5's llama3.2-3b weights at full width and
    depth.  A reference engine (fused staging, dedup off, FEAT_SPILL spill
    slots) serves FEAT_PROMPTS prompts of FEAT_PAGES pages with a
    FEAT_SHARED-page common prefix for PREEMPT_ROUNDS rounds; against it:

    (a) the same prompts with ``dedup_admit=True``: 18 pages shared by 3
        admissions, 14 resident blocks against 32 after admission,
        identical tokens over FEAT_ROUNDS rounds, logits within
        SERVE_RTOL;
    (b) the third sequence demoted before round PREEMPT_AT and resumed
        before round RESUME_AT: the parked spill slots and the resumed
        blocks bitwise equal to the source blocks, the resumed tokens
        identical to the reference's, the demote and resume rows in the
        round's one K1 launch, their card ms against the bytes' bound;
    (c) a ring of FEAT_RING slots, double-buffered: two admissions of
        FEAT_PAGES pages in one round drain as one K1 launch, a window of
        rounds without admission shrinks the ring once, the next
        admission regrows it with no flush of its own;
    (d) the ``fused_staging=False`` leg: tokens and K/V pools after the
        admissions' round bitwise equal to the reference's, staging as
        ``legacy_stage`` events and no K1 launch; admission card ms of
        both legs.

    K1 <= 1 launch a round throughout.  Returns the phase's launch counts
    by kernel."""
    from repro_torch.kernels import fused_dispatch as fd
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import ServingEngine
    from repro_torch.obs import metrics
    cfg = params.cfg
    counters = ops.KERNEL_COUNTERS
    k1 = counters["fused_dispatch"]
    page = 64
    rng = np.random.default_rng(SEED + 15)
    shared = rng.integers(2, cfg.vocab_size, size=FEAT_SHARED * page)
    prompts = [np.concatenate([shared, rng.integers(
        2, cfg.vocab_size, size=(FEAT_PAGES - FEAT_SHARED) * page)])
        .astype(np.int32) for _ in range(FEAT_PROMPTS)]
    tag = "[llama3.2-3b features]"

    def engine(**kw):
        return ServingEngine(cfg, params, max_seqs=MAX_SEQS,
                             max_blocks_per_seq=MAX_BLOCKS_PER_SEQ, **kw)

    checks = {}
    t_phase = time.perf_counter()
    for c in counters.values():
        c.reset()

    # the reference run: fused staging, dedup off, spill pools
    ref = engine(spill_pages=FEAT_SPILL)
    block_bytes = ref.engine._block_bytes()
    # an engine holds its allocator's reserved zero blocks from the start
    reserved = ref.kv_bytes_live()
    k1_admit = k1.n
    _admit_all(ref, prompts)
    k1_admit = k1.n - k1_admit
    ref_live = ref.kv_bytes_live() - reserved
    first_pools = {}

    def keep_pools(rnd):
        if rnd == 2:
            first_pools.update({n: ref.engine.pools[n].clone()
                                for n in ("k", "v")})

    ref_k1, ref_logits = _serve_rounds(ref, PREEMPT_ROUNDS, keep_pools)
    ref_tokens = {s: list(t) for s, t in ref.tokens.items()}
    ref_group = len(ref.engine.group.names)
    del ref
    torch.cuda.empty_cache()
    log(f"{tag} reference: {FEAT_PROMPTS} prompts of {FEAT_PAGES * page} "
        f"tokens ({FEAT_SHARED * page}-token common prefix), "
        f"{ref_group} pools in K1's group (K/V, staging ring, "
        f"{FEAT_SPILL} spill slots), K1 per round {ref_k1} ({smi})")
    checks["reference: no K1 launch at admission, <= 1 a round"] = \
        k1_admit == 0 and max(ref_k1) <= 1 and ref_k1[0] == 1

    # (a) dedup-on-admit
    on = engine(dedup_admit=True)
    _admit_all(on, prompts)
    on_live = on.kv_bytes_live() - reserved
    on_k1, on_logits = _serve_rounds(on, FEAT_ROUNDS)
    err, limit, same = _logit_diff(on_logits[-1],
                                   ref_logits[FEAT_ROUNDS - 1])
    shared_pages = (FEAT_PROMPTS - 1) * FEAT_SHARED
    resident = FEAT_PAGES + (FEAT_PROMPTS - 1) * (FEAT_PAGES - FEAT_SHARED)
    checks.update({
        "(a) dedup: tokens identical": all(
            on.tokens[s] == ref_tokens[s][:len(on.tokens[s])]
            for s in on.tokens),
        "(a) dedup: logits within SERVE_RTOL": err <= limit,
        f"(a) dedup_pages_shared == {shared_pages}, dedup_hits == "
        f"{FEAT_PROMPTS - 1}": (on.dedup_pages_shared, on.dedup_hits)
        == (shared_pages, FEAT_PROMPTS - 1),
        f"(a) kv_bytes_live {resident} blocks against "
        f"{FEAT_PROMPTS * FEAT_PAGES}": (on_live, ref_live) == (
            resident * block_bytes, FEAT_PROMPTS * FEAT_PAGES * block_bytes),
        "(a) K1 <= 1 a round": max(on_k1) <= 1,
    })
    log(f"{tag} (a) dedup-on-admit: {on.dedup_hits} hits, "
        f"{on.dedup_pages_shared} pages shared, kv_bytes_live after "
        f"admission {on_live} B against {ref_live} B without dedup (above "
        f"the {reserved} B of reserved zero blocks) "
        f"({on.dedup_bytes_saved} B saved); K1 per round {on_k1}; logits "
        f"after round {FEAT_ROUNDS} vs dedup off: max |diff| {err:.3e} "
        f"(limit {limit:.3e}, bitwise {same}) ({smi})")
    del on
    torch.cuda.empty_cache()

    # (b) demote and resume
    pre = engine(spill_pages=FEAT_SPILL)
    psids = _admit_all(pre, prompts)
    victim = psids[2]
    moved = {}

    def preempt(rnd):
        if rnd == PREEMPT_AT:
            blocks = pre.cache.blocks_of(victim)
            moved["blocks"] = blocks
            moved["before"] = {n: pre.engine.pools[n][:, blocks].clone()
                               for n in ("k", "v")}
            pre.demote(victim)
            moved["slots"] = list(pre.demoted[victim].slots)
        elif rnd == RESUME_AT:
            slots = moved["slots"]
            moved["parked"] = {n: pre.engine.pools[n + "_spill"][:, slots]
                               .clone() for n in ("k", "v")}
            moved["sid"] = sid = pre.resume(victim)
            fresh = pre.cache.blocks_of(sid)
            moved["fresh"] = fresh

            def land(n_rows, n_pools, mech):
                if mech == "fused" and "landed" not in moved:
                    moved["landed"] = {
                        n: pre.engine.pools[n][:, fresh].clone()
                        for n in ("k", "v")}
            moved["hook"] = land
            fd.add_launch_hook(land)

    with K1Events() as timer:
        try:
            pre_k1, pre_logits = _serve_rounds(pre, PREEMPT_ROUNDS, preempt,
                                               timer)
        finally:
            if "hook" in moved:
                fd.remove_launch_hook(moved["hook"])
    k1_ms = timer.by_round()
    new = moved["sid"]
    resumed = pre.tokens[new]
    n_blocks = len(moved["blocks"])
    gen = PREEMPT_ROUNDS - (RESUME_AT - PREEMPT_AT)
    # the resumed sequence after round R has the tokens of the reference's
    # after round R - (RESUME_AT - PREEMPT_AT)
    want_logits = ref_logits[gen - 1][victim]
    err_b, limit_b, same_b = _logit_diff({victim: pre.last_logits[new]},
                                         {victim: want_logits})
    others = {s: pre.last_logits[s] for s in psids if s != victim}
    err_o, limit_o, _ = _logit_diff(others, {
        s: ref_logits[-1][s] for s in others})
    st = pre.engine.stats
    page_bytes = block_bytes // 2
    rows_ms = {}
    for name, rnd in (("demote", PREEMPT_AT), ("resume", RESUME_AT)):
        (ms, rows), = k1_ms[rnd]
        rows_ms[name] = (ms, rows, cost.block_move_bytes(rows, 1, page_bytes,
                                                         2)
                         / cost.HBM_BYTES_PER_S * 1e3)
    checks.update({
        "(b) parked spill slots == source blocks, bitwise": all(
            _bitwise_equal(moved["parked"][n], moved["before"][n])
            for n in ("k", "v")),
        "(b) resumed blocks == parked slots, bitwise": all(
            _bitwise_equal(moved["landed"][n], moved["parked"][n])
            for n in ("k", "v")),
        "(b) resumed tokens identical": resumed ==
        ref_tokens[victim][:len(resumed)],
        "(b) resumed logits within SERVE_RTOL": err_b <= limit_b,
        "(b) other sequences' logits within SERVE_RTOL": err_o <= limit_o,
        "(b) K1 <= 1 a round, demote and resume rows in it":
            max(pre_k1) <= 1 and pre_k1[PREEMPT_AT - 1] == 1
            and pre_k1[RESUME_AT - 1] == 1,
        f"(b) demotions == spill_promotions == {n_blocks}":
            st.demotions == st.spill_promotions == n_blocks,
        "(b) spill slots all free again":
            pre.engine.spill_slots_free == FEAT_SPILL,
    })
    log(f"{tag} (b) demote seq {victim} ({n_blocks} blocks) before round "
        f"{PREEMPT_AT}, resume as seq {new} before round {RESUME_AT}; K1 "
        f"per round {pre_k1}; " + "; ".join(
            f"{name} round K1 {ms:.4f} card ms, {rows} rows "
            f"({2 * rows * page_bytes} B, bound {bound:.4f} ms)"
            for name, (ms, rows, bound) in rows_ms.items())
        + f"; resumed logits vs unpreempted: max |diff| {err_b:.3e} (limit "
        f"{limit_b:.3e}, bitwise {same_b}), others {err_o:.3e} ({smi})")
    del pre
    torch.cuda.empty_cache()

    # (c) the double-buffered, adaptive ring
    metrics.reset()
    ring = engine(max_admit_pages=FEAT_RING, double_buffer=True)
    n0 = k1.n
    for p in prompts[:2]:
        ring.add_request(p)
    burst_admit = k1.n - n0
    burst_k1, _ = _serve_rounds(ring, 1)
    idle, shrunk_at = 0, None
    while shrunk_at is None and idle < 2 * ring.RING_WINDOW:
        _serve_rounds(ring, 1)
        idle += 1
        if ring.ring_shrinks:
            shrunk_at = idle + 1
    limit_c = ring.engine.stage_limit
    gauge = metrics.gauge_value("engine.stage_limit")
    n0 = k1.n
    ring.add_request(prompts[2])
    regrow_admit = k1.n - n0
    regrow_k1, _ = _serve_rounds(ring, 1)
    checks.update({
        f"(c) burst of {2 * FEAT_PAGES} pages on a {FEAT_RING}-slot ring: "
        "one K1 launch": burst_admit == 0 and burst_k1 == [1],
        "(c) one shrink after a window without admission":
            ring.ring_shrinks == 1 and shrunk_at == 2 * ring.RING_WINDOW
            and limit_c is not None and gauge == limit_c
            and metrics.get("serve.ring_shrinks") == 1,
        "(c) the next admission regrows the ring with no flush of its own":
            ring.ring_regrows == 1 and ring.engine.stage_limit is None
            and regrow_admit == 0 and regrow_k1 == [1]
            and metrics.get("serve.ring_regrows") == 1,
    })
    log(f"{tag} (c) ring of {FEAT_RING} slots x 2: burst admission K1 "
        f"{burst_admit}, its round {burst_k1}; shrink at round {shrunk_at} "
        f"to {limit_c} slots (engine.stage_limit gauge {gauge}); regrow "
        f"{ring.ring_regrows}, admission K1 {regrow_admit}, its round "
        f"{regrow_k1} ({smi})")
    del ring
    torch.cuda.empty_cache()

    # (d) the fused_staging=False leg
    legacy = engine(fused_staging=False)
    events = []
    hook = (lambda n, p, m: events.append(m))
    fd.add_launch_hook(hook)
    n0 = k1.n
    try:
        _admit_all(legacy, prompts)
    finally:
        fd.remove_launch_hook(hook)
    legacy_admit_k1 = k1.n - n0
    pools_equal = {}

    def compare_pools(rnd):
        if rnd == 2:
            pools_equal.update({n: _bitwise_equal(legacy.engine.pools[n],
                                                  first_pools[n])
                                for n in ("k", "v")})

    legacy_k1, _ = _serve_rounds(legacy, FEAT_ROUNDS, compare_pools)
    first_pools.clear()
    checks.update({
        "(d) legacy leg: tokens identical": all(
            legacy.tokens[s] == ref_tokens[s][:len(legacy.tokens[s])]
            for s in legacy.tokens),
        "(d) legacy leg: K/V pools after the admissions' round bitwise":
            pools_equal == {"k": True, "v": True},
        "(d) legacy staging: legacy_stage events, no K1 launch":
            events == ["legacy_stage"] * (2 * FEAT_PROMPTS)
            and legacy_admit_k1 == 0,
    })
    log(f"{tag} (d) fused_staging=False: K1 per round {legacy_k1}; "
        f"{len(events)} legacy_stage events ({smi})")
    del legacy
    torch.cuda.empty_cache()
    # the two legs' admissions in turns on fresh engines (fused, legacy,
    # legacy, fused): median card ms of the 4 admissions (the fused leg's
    # promotions drain in its first round, not here), then the staging
    # write's device ms (index_copy_ into the ring or the K/V pools) in a
    # profiled fifth
    from torch.profiler import ProfilerActivity, profile
    turns = []
    for fused in (True, False, False, True):
        eng = engine(fused_staging=fused)
        _, ms = _timed_admissions(eng, prompts)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            eng.add_request(prompts[0])
            torch.cuda.synchronize()
        write = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and "index_copy" in e.key) / 1e3
        turns.append(f"{'fused' if fused else 'legacy'} "
                     f"{np.median(ms):.2f} ms (write {write:.4f} ms)")
        del eng
        torch.cuda.empty_cache()
    log(f"{tag} (d) admissions in turns, median card ms of 4 and the "
        f"staging write's device ms: {'; '.join(turns)} ({smi})")

    launches = {n: c.n for n, c in counters.items()}
    log(f"{tag} phase 15 took {time.perf_counter() - t_phase:.1f} s")
    for name, ok in checks.items():
        log(f"{tag} {'ok  ' if ok else 'FAIL'} {name}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"serving features checks failed: {failed}")
    return launches


# ---------------------------------------------------------------------------
# phase 14: the vlm family through the facade pair
# ---------------------------------------------------------------------------

#: phase 14: a batch of 4 prompts of 128 text tokens behind the 256 patch
#: embeddings (384 positions, 6 pages), one prompt of 57 (313 positions,
#: a ragged last tile), and greedy decode steps on the batch
VLM_BATCH, VLM_TEXT, VLM_RAGGED, VLM_STEPS = 4, 128, 57, 16


def phase_vlm(arch: str = "paligemma-3b") -> dict:
    """Phase 14: ``arch`` at full width and depth with random bf16 weights
    from seed 0 and patch embeddings drawn from the seed with numpy
    (N(0, 1) x 0.02), through ``LanguageModel.prefill_state`` /
    ``decode_state``: prefill the batch and the ragged prompt, then
    :data:`VLM_STEPS` greedy decode steps on the batch.  Checks K3 ==
    layers per prefill and K2 == layers per step, the allocated parameters
    against ``param_count()``, finite logits, the prefill and first-step
    logits against the same calls through the plain versions, and every K2
    / K3 call of the two prefills and the first step against its plain
    version on the same inputs.  Returns the launch counts of the counted
    run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.weights import init_params
    cfg = get_config(arch)
    t0 = time.perf_counter()
    model = init_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"[{arch}] {cfg.family}, full depth: {cfg.num_layers} decoder "
        f"layers, d_model {cfg.d_model}, {cfg.num_heads} heads over "
        f"{cfg.num_kv_heads} KV head x {cfg.head_dim}, d_ff {cfg.d_ff}, "
        f"{cfg.vision_tokens} patch embeddings (prefix-LM), tied head "
        f"{cfg.padded_vocab} wide; param_count() "
        f"{cfg.param_count() / 1e9:.3f} B, allocated {n_params / 1e9:.3f} B "
        f"params ({n_bytes / 1e9:.2f} GB), init "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)

    def prompt(B, S):
        tokens = rng.integers(2, cfg.vocab_size, (B, S))
        patches = rng.standard_normal((B, cfg.vision_tokens, cfg.d_model))
        return (torch.from_numpy(tokens).cuda(),
                torch.from_numpy((patches * 0.02).astype(np.float32)).cuda())

    batch, single = prompt(VLM_BATCH, VLM_TEXT), prompt(1, VLM_RAGGED)
    L = cfg.num_layers
    counters = ops.KERNEL_COUNTERS

    def counts():
        return {n: c.n for n, c in counters.items()}

    for c in counters.values():
        c.reset()
    torch.cuda.synchronize()
    checks = {"allocated parameters == param_count() + the final norm":
              n_params == cfg.param_count() + cfg.d_model}
    out = {}
    for name, inputs in (("batch", batch), ("ragged", single)):
        before = counts()
        t = time.perf_counter()
        logits, state = model.prefill_state(*inputs)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        got = {n: counts()[n] - before[n] for n in counters}
        checks[f"{name} prefill: K3 == layers"] = \
            got["flash_attention"] == L
        checks[f"{name} prefill: no K2"] = got["paged_attention"] == 0
        checks[f"{name} prefill logits finite"] = \
            bool(torch.isfinite(logits).all())
        out[name] = (logits, state, ms)
        S = int(state["seq_lens"][0])
        log(f"[{arch}] prefill {tuple(inputs[0].shape)} text tokens + "
            f"{cfg.vision_tokens} patches = {S} positions: {ms:.1f} ms (host "
            f"clock, synchronised), {inputs[0].shape[0] * S / ms * 1e3:.0f} "
            f"positions/s, K3 {got['flash_attention']} launches; state "
            f"{_state_bytes(state) / 1e6:.1f} MB")
    logits, state, _ = out["batch"]
    prefill_logits, ragged_logits = logits, out["ragged"][0]
    tok = logits.argmax(-1)
    step_ms, per_step, first = [], [], None
    for step in range(VLM_STEPS):
        before = counts()
        t = time.perf_counter()
        logits, state = model.decode_state(state, tok)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        per_step.append({n: counts()[n] - before[n] for n in counters})
        if step == 0:
            first = (tok.clone(), logits.clone())
        tok = logits.argmax(-1)
    launches = counts()
    checks["decode: K2 == layers per step"] = all(
        g["paged_attention"] == L for g in per_step)
    checks["decode: no K3"] = all(g["flash_attention"] == 0
                                  for g in per_step)
    checks["decode logits finite"] = bool(torch.isfinite(logits).all())
    med = float(np.median(step_ms[1:]))
    log(f"[{arch}] {VLM_STEPS} greedy decode steps on {VLM_BATCH} "
        f"sequences: median {med:.2f} ms/step (steps 2-{VLM_STEPS}), "
        f"{VLM_BATCH * VLM_STEPS / (sum(step_ms) / 1e3):.1f} tokens/s over "
        f"all steps; state {_state_bytes(state) / 1e6:.1f} MB (seq_lens "
        f"{int(state['seq_lens'][0])})")
    log(f"[{arch}] launches (counted run: 2 prefills + {VLM_STEPS} steps): "
        + " ".join(f"{k}={launches[k]}" for k in
                   ("flash_attention", "paged_attention", "fused_dispatch")))
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{arch} checks failed: {failed}")
    profile_rounds(lambda: model.decode_state(state, tok), tag=arch,
                   what="step")
    profile_rounds(lambda: model.prefill_state(*batch), rounds=2, tag=arch,
                   what="prefill")
    del state, out

    # the same calls through the plain versions
    with ops.plain_versions():
        p_batch, p_state = model.prefill_state(*batch)
        p_single, _ = model.prefill_state(*single)
        p_step, _ = model.decode_state(p_state, first[0])
    torch.cuda.synchronize()
    for what, a, b in (("batch prefill", prefill_logits, p_batch),
                       ("ragged prefill", ragged_logits, p_single),
                       ("first decode step", first[1], p_step)):
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        agree = int((a.argmax(-1) == b.argmax(-1)).sum())
        log(f"[{arch}] {what} logits vs plain versions: max |diff| "
            f"{err:.3e} (limit {SERVE_RTOL} x max |logit| = "
            f"{SERVE_RTOL * scale:.3e}); argmax agrees on "
            f"{agree}/{a.shape[0]}")
        if not err <= SERVE_RTOL * scale:
            raise AssertionError(f"{arch} {what} logits differ from the "
                                 "plain versions")
    del p_state

    # every kernel call of the path against its plain version on the same
    # inputs (the calls' check of record)
    def path():
        _, st = model.prefill_state(*batch)
        model.prefill_state(*single)
        model.decode_state(st, first[0])

    _, reads = tapped(path)
    log(f"[{arch}] every kernel call vs its plain version on the same "
        "inputs: " + _fmt_reads(reads))
    calls = {op: r["calls"] for op, r in reads.items()}
    if calls != {"flash_attention": 2 * L, "paged_attention_slab": L} or \
            any(r["err"] > r["limit"] for r in reads.values()):
        raise AssertionError(f"{arch}: kernel calls vs plain: {reads}")
    del model
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 16: the encdec family through the facade pair, and the engine's
# admission of the encdec and hybrid families
# ---------------------------------------------------------------------------

#: phase 16: a batch of 4 prompts of 512 tokens over 128 source frames, one
#: of 57 tokens over 14 frames (ragged tiles in every kind of attention),
#: and greedy decode steps on the batch
ENC_BATCH, ENC_TEXT, ENC_RAGGED, ENC_STEPS = 4, 512, 57, 16
#: phase 16b: the prompts admitted into the serving engine, per family
ADMIT_LENS = (250, 512)


def phase_encdec(arch: str = "seamless-m4t-medium"):
    """Phase 16: ``arch`` at full width and depth with random bf16 weights
    from seed 0 and source frames drawn from the seed with numpy (N(0, 1)
    x 0.02, ``S // src_frames_ratio`` of them), through
    ``LanguageModel.prefill_state`` / ``decode_state``: prefill the batch
    and the ragged prompt, then :data:`ENC_STEPS` greedy decode steps on
    the batch.  Checks K3 == encoder + 2 x decoder layers per prefill (the
    encoder's, the decoder's causal and its cross-attention calls), K2 ==
    K3 == decoder layers per step (self-attention over the pools, one
    query over the frames), the allocated parameters against
    ``param_count()``, finite logits, the prefill and first-step logits
    against the plain versions, and every K2 / K3 call of the two prefills
    and the first step against its plain version on the same inputs.
    Returns the launch counts of the counted run and the model."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.weights import init_params
    cfg = get_config(arch)
    t0 = time.perf_counter()
    model = init_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"[{arch}] {cfg.family}, full depth: {cfg.encoder_layers} encoder + "
        f"{cfg.num_layers} decoder layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads} heads over {cfg.num_kv_heads} KV heads x "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, untied head {cfg.padded_vocab} "
        f"wide; param_count() {cfg.param_count():,}, allocated "
        f"{n_params:,} params ({n_bytes / 1e9:.2f} GB), init "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)

    def prompt(B, S):
        tokens = rng.integers(2, cfg.vocab_size, (B, S))
        frames = rng.standard_normal(
            (B, max(S // cfg.src_frames_ratio, 1), cfg.d_model)) * 0.02
        return (torch.from_numpy(tokens).cuda(),
                torch.from_numpy(frames.astype(np.float32)).cuda())

    batch, single = prompt(ENC_BATCH, ENC_TEXT), prompt(1, ENC_RAGGED)
    L = cfg.num_layers
    per_prefill = cfg.encoder_layers + 2 * L
    counters = ops.KERNEL_COUNTERS

    def counts():
        return {n: c.n for n, c in counters.items()}

    def prefill(inputs):
        return model.prefill_state(inputs[0], src_embeds=inputs[1])

    for c in counters.values():
        c.reset()
    torch.cuda.synchronize()
    checks = {"allocated parameters == param_count() + the final and "
              "encoder norms": n_params == cfg.param_count() + 2 * cfg.d_model}
    out = {}
    for name, inputs in (("batch", batch), ("ragged", single)):
        before = counts()
        t = time.perf_counter()
        logits, state = prefill(inputs)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        got = {n: counts()[n] - before[n] for n in counters}
        checks[f"{name} prefill: K3 == encoder + 2 x decoder layers"] = \
            got["flash_attention"] == per_prefill
        checks[f"{name} prefill: no K2"] = got["paged_attention"] == 0
        checks[f"{name} prefill logits finite"] = \
            bool(torch.isfinite(logits).all())
        checks[f"{name} prefill: cross K/V over the frames"] = \
            tuple(state["cross_k"].shape) == (L,) + tuple(
                inputs[1].shape[:2]) + (cfg.num_kv_heads, cfg.head_dim)
        out[name] = (logits, state, ms)
        B, S = inputs[0].shape
        log(f"[{arch}] prefill {B} x {S} tokens over {inputs[1].shape[1]} "
            f"frames: {ms:.1f} ms (host clock, synchronised), "
            f"{B * S / ms * 1e3:.0f} tokens/s, K3 {got['flash_attention']} "
            f"launches; state {_state_bytes(state) / 1e6:.1f} MB (cross K/V "
            f"{2 * state['cross_k'].numel() * 2:,} B)")
    logits, state, _ = out["batch"]
    prefill_logits, ragged_logits = logits, out["ragged"][0]
    tok = logits.argmax(-1)
    step_ms, per_step, first = [], [], None
    for step in range(ENC_STEPS):
        before = counts()
        t = time.perf_counter()
        logits, state = model.decode_state(state, tok)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        per_step.append({n: counts()[n] - before[n] for n in counters})
        if step == 0:
            first = (tok.clone(), logits.clone())
        tok = logits.argmax(-1)
    launches = counts()
    checks["decode: K2 == decoder layers per step"] = all(
        g["paged_attention"] == L for g in per_step)
    checks["decode: K3 == decoder layers per step (cross)"] = all(
        g["flash_attention"] == L for g in per_step)
    checks["decode logits finite"] = bool(torch.isfinite(logits).all())
    med = float(np.median(step_ms[1:]))
    log(f"[{arch}] {ENC_STEPS} greedy decode steps on {ENC_BATCH} "
        f"sequences: median {med:.2f} ms/step (steps 2-{ENC_STEPS}), "
        f"{ENC_BATCH * ENC_STEPS / (sum(step_ms) / 1e3):.1f} tokens/s over "
        f"all steps; state {_state_bytes(state) / 1e6:.1f} MB (seq_lens "
        f"{int(state['seq_lens'][0])})")
    log(f"[{arch}] launches (counted run: 2 prefills + {ENC_STEPS} steps): "
        + " ".join(f"{k}={launches[k]}" for k in
                   ("flash_attention", "paged_attention", "fused_dispatch")))
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{arch} checks failed: {failed}")
    profile_rounds(lambda: model.decode_state(state, tok), tag=arch,
                   what="step")
    profile_rounds(lambda: prefill(batch), rounds=2, tag=arch,
                   what="prefill")
    del state, out

    # the same calls through the plain versions
    with ops.plain_versions():
        p_batch, p_state = prefill(batch)
        p_single, _ = prefill(single)
        p_step, _ = model.decode_state(p_state, first[0])
    torch.cuda.synchronize()
    for what, a, b in (("batch prefill", prefill_logits, p_batch),
                       ("ragged prefill", ragged_logits, p_single),
                       ("first decode step", first[1], p_step)):
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        agree = int((a.argmax(-1) == b.argmax(-1)).sum())
        log(f"[{arch}] {what} logits vs plain versions: max |diff| "
            f"{err:.3e} (limit {SERVE_RTOL} x max |logit| = "
            f"{SERVE_RTOL * scale:.3e}); argmax agrees on "
            f"{agree}/{a.shape[0]}")
        if not err <= SERVE_RTOL * scale:
            raise AssertionError(f"{arch} {what} logits differ from the "
                                 "plain versions")
    del p_state

    def path():
        _, st = prefill(batch)
        prefill(single)
        model.decode_state(st, first[0])

    _, reads = tapped(path)
    log(f"[{arch}] every kernel call vs its plain version on the same "
        "inputs: " + _fmt_reads(reads))
    calls = {op: r["calls"] for op, r in reads.items()}
    if calls != {"flash_attention": 2 * per_prefill + L,
                 "paged_attention_slab": L} or \
            any(r["err"] > r["limit"] for r in reads.values()):
        raise AssertionError(f"{arch}: kernel calls vs plain: {reads}")
    torch.cuda.empty_cache()
    return launches, model


def phase_admission(model) -> dict:
    """Phase 16b: ``ServingEngine`` (8 sequences x 64 blocks) admits the
    :data:`ADMIT_LENS` prompts of ``model``'s family (encdec or hybrid) at
    full width through the facade's prefill (an encdec's over zero source
    frames, as the reference's admission), and one round's flush of the
    serve stream drains their promotions.  Checks K3 (and for the hybrid
    K4) once per attention (Mamba2) layer and admission, no K1 at
    admission and one K1 launch in the round, the promoted blocks bitwise
    equal to the facade's prefill of the same prompt (no decode margin),
    ``_extras`` bitwise equal to that prefill's state (shapes included),
    ``decode_round`` refused with the reference's message, and after
    ``free`` the allocator and ``_extras`` back where they started.
    Returns the launch counts of the admissions and the round."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import (DECODE_REFUSAL, EXTRA_KEYS,
                                          ServingEngine)
    cfg = model.cfg
    tag = f"[{cfg.arch_id} admission]"
    eng = ServingEngine(cfg, model, max_seqs=MAX_SEQS,
                        max_blocks_per_seq=MAX_BLOCKS_PER_SEQ)
    alloc = eng.engine.alloc
    free0 = alloc.total_free()
    rng = np.random.default_rng(SEED + 16)
    prompts = [rng.integers(2, cfg.vocab_size, n).astype(np.int32)
               for n in ADMIT_LENS]
    counters = ops.KERNEL_COUNTERS

    def counts():
        return {n: c.n for n, c in counters.items()}

    for c in counters.values():
        c.reset()
    torch.cuda.synchronize()
    checks = {}
    per_admit = cfg.num_attn_layers + (cfg.encoder_layers +
                                       cfg.num_layers
                                       if cfg.family == "encdec" else 0)
    sids = []
    for p in prompts:
        before = counts()
        t = time.perf_counter()
        sids.append(eng.add_request(p))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        got = {n: counts()[n] - before[n] for n in counters}
        checks[f"{len(p)}-token admission: K3 == {per_admit}"] = \
            got["flash_attention"] == per_admit
        if cfg.family == "hybrid":
            checks[f"{len(p)}-token admission: K4 == Mamba2 layers"] = \
                got["ssd_intra_chunk"] == cfg.num_layers
        checks[f"{len(p)}-token admission: no K1"] = \
            got["fused_dispatch"] == 0
        log(f"{tag} {len(p)} tokens: {ms:.1f} ms (host clock, "
            f"synchronised), {len(eng.cache.blocks_of(sids[-1]))} blocks "
            f"staged; extras " + ", ".join(
                f"{k} {tuple(t.shape)}"
                for k, t in eng._extras[sids[-1]].items()))
    before = counts()
    eng.stream.flush()
    eng._post_flush()
    torch.cuda.synchronize()
    k1 = counts()["fused_dispatch"] - before["fused_dispatch"]
    launches = counts()
    checks["the round's flush: one K1 launch"] = k1 == 1
    for sid, p in zip(sids, prompts):
        extra = {}
        if cfg.family == "encdec":
            extra["src_embeds"] = torch.zeros(
                (1, max(len(p) // cfg.src_frames_ratio, 1), cfg.d_model),
                device="cuda")
        _, st = model.prefill_state(torch.from_numpy(p)[None].long().cuda(),
                                    margin_tokens=0, **extra)
        blocks = eng.cache.blocks_of(sid)
        checks[f"{len(p)}-token promoted blocks == facade prefill, "
               "bitwise"] = all(
            torch.equal(eng.engine.pools[n][:, blocks], st[n + "_pools"])
            for n in ("k", "v"))
        held = eng._extras[sid]
        checks[f"{len(p)}-token _extras == facade state, bitwise"] = \
            sorted(held) == sorted(k for k in EXTRA_KEYS if k in st) and \
            all(torch.equal(t, st[k]) for k, t in held.items())
    try:
        eng.decode_round()
        checks["decode_round refused"] = False
    except NotImplementedError as err:
        checks["decode_round refused"] = str(err) == DECODE_REFUSAL
    for sid in sids:
        eng.free(sid)
    checks["after free: allocator and _extras as at the start"] = \
        alloc.total_free() == free0 and eng._extras == {} and \
        not eng.cache.seqs
    log(f"{tag} launches (admissions + the round's flush): " + " ".join(
        f"{k}={launches[k]}" for k in ("flash_attention", "ssd_intra_chunk",
                                       "fused_dispatch")))
    for name, ok in checks.items():
        log(f"{tag} {'ok  ' if ok else 'FAIL'} {name}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{cfg.arch_id} admission checks failed: "
                             f"{failed}")
    del eng
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 17: the traffic layer
# ---------------------------------------------------------------------------

#: phase 17: rounds of arrivals per traffic leg (``bench_dispatch.py``
#: TRAFFIC_ROUNDS) and the tokens per request of the preemption parity
#: script (TRAFFIC_PARITY_TOKENS)
TRAFFIC_ROUNDS, PARITY_TOKENS = 32, 8
#: the Fig. 3/4 mix's model, at full width and depth
FIG34_ARCH = "yi-6b"


def _top2(logits) -> float:
    top = np.sort(logits)[-2:]
    return float(top[1] - top[0])


class RoundLog:
    """Wraps one serving engine's ``decode_round``, which the scheduler
    calls once a step: per call, K1 launches since the previous call
    returned (a flush forced while the lanes merge counts in its round)
    and the ``RoundReport`` count to hold them against (the ticket's
    launches, or 0 where ``last_ticket`` is the previous round's); before
    the call, each live sequence's top-1 / top-2 logit margin by request
    id (``sched`` maps the sequences)."""

    def __init__(self, eng, sched=None):
        from repro_torch.kernels import ops
        self.eng, self.sched = eng, sched
        self.k1 = ops.KERNEL_COUNTERS["fused_dispatch"]
        self.rounds, self.margins = [], []
        self._n, self._ticket = self.k1.n, eng.last_ticket
        self._call = eng.decode_round
        eng.decode_round = self

    def __call__(self, *a, **kw):
        eng = self.eng
        if self.sched is not None:
            by_sid = self.sched._by_sid
            self.margins.append({by_sid[s]: _top2(eng.last_logits[s])
                                 for s in eng.cache.seqs if s in by_sid})
        out = self._call(*a, **kw)
        fresh = eng.last_ticket is not self._ticket
        self._ticket = eng.last_ticket
        self.rounds.append((self.k1.n - self._n,
                            self._ticket.launches if fresh else 0))
        self._n = self.k1.n
        return out

    def agree(self) -> bool:
        """<= 1 K1 launch in every round, equal to the report's count."""
        return all(got <= 1 and got == rep for got, rep in self.rounds)


class ParkWatch:
    """The bytes each ``demote`` parks in the spill slots and each
    ``resume`` brings back, held bitwise against their sources at the K1
    launch that moves them."""

    def __init__(self, eng):
        from repro_torch.kernels import fused_dispatch as fd
        self.eng, self.todo, self.checked, self.bad = eng, [], 0, 0
        self._demote, self._resume = eng.demote, eng.resume
        eng.demote, eng.resume = self.demote, self.resume
        self._fd = fd
        fd.add_launch_hook(self)

    def close(self):
        self._fd.remove_launch_hook(self)

    def demote(self, sid, stream=None):
        pools = self.eng.engine.pools
        blocks = self.eng.cache.blocks_of(sid)
        before = {n: pools[n][:, blocks].clone() for n in ("k", "v")}
        self._demote(sid, stream=stream)
        self.todo.append((self.eng.demoted[sid].slots, "_spill", before))

    def resume(self, sid, stream=None):
        pools = self.eng.engine.pools
        slots = self.eng.demoted[sid].slots
        parked = {n: pools[n + "_spill"][:, slots].clone()
                  for n in ("k", "v")}
        new = self._resume(sid, stream=stream)
        self.todo.append((self.eng.cache.blocks_of(new), "", parked))
        return new

    def __call__(self, n_rows, n_pools, mech):
        if mech != "fused":
            return
        pools = self.eng.engine.pools
        for ids, suffix, want in self.todo:
            for name in ("k", "v"):
                self.checked += 1
                self.bad += not _bitwise_equal(pools[name + suffix][:, ids],
                                               want[name])
        self.todo = []


def _capacity(eng) -> tuple:
    """What a drained engine gives back: free blocks, live sequences,
    staging slots free + parked, spill slots free, parked sequences."""
    e = eng.engine
    return (e.alloc.total_free(), len(eng.cache.seqs),
            len(e._stage_free) + len(e._stage_parked), e.spill_slots_free,
            len(eng.demoted))


def _schedule(rep) -> tuple:
    """A RoundReport's schedule fields (no launch count, no clock)."""
    return (rep.round_index, rep.admitted, rep.finished, rep.preempted,
            rep.resumed, rep.tokens)


def _counts() -> dict:
    from repro_torch.kernels import ops
    return {n: c.n for n, c in ops.KERNEL_COUNTERS.items()}


def _since(before: dict) -> dict:
    return {n: c - before.get(n, 0) for n, c in _counts().items()}


def check_run(fn, checked: dict):
    """Run ``fn``, a run that only holds kernels against their plain
    versions, and add its launches to ``checked``, so that a path's count
    leaves them out (also when ``fn`` raises)."""
    c0 = _counts()
    try:
        return fn()
    finally:
        for n, c in _since(c0).items():
            checked[n] = checked.get(n, 0) + c


def _preempt_script(eng, prompts, tokens=PARITY_TOKENS, tap=False):
    """``bench_dispatch.py _traffic_parity``'s script: two free requests,
    two rounds, a gold arrival, drain.  Returns the scheduler, the request
    ids in submission order, its RoundLog and the K2 / K3 reads (``tap``:
    every call held against its plain version)."""
    from repro_torch.launch.scheduler import RequestScheduler, TenantSpec
    sched = RequestScheduler(eng, [TenantSpec("gold", 2),
                                   TenantSpec("free", 0)])
    rl = RoundLog(eng, sched)

    def run():
        rids = [sched.submit("free", p, max_new_tokens=tokens)
                for p in prompts[:2]]
        sched.step()
        sched.step()
        rids.append(sched.submit("gold", prompts[2], max_new_tokens=tokens))
        sched.drain(max_rounds=120)
        return rids

    rids, reads = tapped(run) if tap else (run(), {})
    torch.cuda.synchronize()
    return sched, rids, rl, reads


def phase_traffic(params, smi: str) -> dict:
    """Phase 17: the traffic layer (``launch/scheduler.py``,
    ``launch/multitenant.py``) at full width, on phase 5's llama3.2-3b
    weights, then the Fig. 3/4 mix on yi-6b.

    (a) ``run_traffic`` poisson and bursty, TRAFFIC_ROUNDS rounds at seed 0,
        over the reference's undersized engine (``traffic_engine``: 4 slots
        x 8 blocks over 2 slabs, an 8-slot double-buffered ring, 8 spill
        slots): <= 1 K1 launch every round and equal to the report's; every
        request done with its tokens; the bursty leg preempts and resumes;
        the allocator, batch slots, ring and spill slots back where they
        started; the schedule fields of every RoundReport equal to a CPU
        replay of the recorded arrival script on the reduced config.  Ms
        per round, launches per round, per-tenant latency, TTFT and
        goodput; a profile of churn rounds (K1, K2, K3, GEMMs, other, host
        gap, idle share) and one churn round's K2 / K3 calls held against
        their plain versions.
    (b) the preemption parity script on a tight engine (2 slots, 8 spill
        slots) against its same-batch twin (2 slots, no spill slots):
        tokens bitwise equal, the gold waiter admitted one round after the
        demotion, each parked and resumed block bitwise equal to its
        source, <= 1 K1 launch a round; the tight run's K2 / K3 calls held
        against their plain versions; the roomy engine's (8 slots)
        agreement printed, with the first differing step and the roomy
        run's top-2 margin there.
    (c) the reference's cancel script: a queued, a running and a parked
        request cancelled, gold done with its 4 tokens, the spill slots
        and the cache empty.
    (d) ``run_dedup`` on llama3.2-3b (tokens match, <= 1 launch a round),
        then ``multitenant.run()`` on yi-6b at full width and depth: the
        weighted speedups of the 1 / 2 / 3-copy mixes, RowClone off and
        on (printed, no threshold: host-bound wall clock), and one mix
        leg's K2 / K3 calls held against their plain versions.

    Returns the launch counts by path ((c) counts with (b))."""
    from repro_torch.configs import get_config
    from repro_torch.launch import multitenant as mt
    from repro_torch.launch.scheduler import RequestScheduler, TenantSpec
    from repro_torch.launch.serve import ServingEngine
    from repro_torch.obs import metrics
    from repro_torch.weights import init_params
    cfg = params.cfg
    tag = "[llama3.2-3b traffic]"
    t_phase = time.perf_counter()
    checks, paths = {}, {}
    rcfg = get_config("llama3.2-3b").reduced()
    rparams = init_params(rcfg, seed=SEED, device="cpu")

    # (a) the traffic legs
    before = _counts()
    legs = {}
    for pattern in ("poisson", "bursty"):
        eng = mt.traffic_engine(cfg, params)
        start = _capacity(eng)
        rl = RoundLog(eng)
        res = mt.run_traffic(pattern, rounds=TRAFFIC_ROUNDS, seed=SEED,
                             eng=eng)
        torch.cuda.synchronize()
        end = _capacity(eng)
        full = (0, eng.engine.stage_capacity, eng.engine.spill_capacity, 0)
        kv = sum(eng.engine.pools[n].numel()
                 * eng.engine.pools[n].element_size() for n in ("k", "v"))
        del eng
        replay = mt.run_traffic(
            pattern, rounds=TRAFFIC_ROUNDS, seed=SEED,
            eng=mt.traffic_engine(rcfg, rparams), script=res.arrivals)
        tokens = sum(sum(r.tokens.values()) for r in res.reports)
        checks.update({
            f"(a) {pattern}: <= 1 K1 launch a round, equal to the report's":
                rl.agree() and len(rl.rounds) == len(res.launches),
            f"(a) {pattern}: every request done with its tokens":
                res.completed == res.submitted > 0
                and tokens == 8 * res.submitted,
            f"(a) {pattern}: allocator, slots, ring, spill slots reclaimed":
                end == start and start[1:] == full,
            f"(a) {pattern}: schedule equal to the CPU replay":
                [_schedule(r) for r in res.reports]
                == [_schedule(r) for r in replay.reports],
        })
        if pattern == "bursty":
            checks["(a) bursty: preempts and resumes"] = \
                len(res.preempted_rids) >= 1 and any(
                    r.resumed for r in res.reports)
        ms = [r.round_us / 1e3 for r in res.reports]
        legs[pattern] = res
        log(f"{tag} (a) {pattern}: {res.submitted} requests over "
            f"{len(res.reports)} rounds ({TRAFFIC_ROUNDS} with arrivals), "
            f"{len(res.preempted_rids)} preempted, "
            f"{sum(len(r.resumed) for r in res.reports)} resumes; ms per "
            f"round median {metrics.percentile(ms, 50):.2f}, p99 "
            f"{metrics.percentile(ms, 99):.2f}; K1 launches per round mean "
            f"{np.mean([g for g, _ in rl.rounds]):.3f}, max "
            f"{max(g for g, _ in rl.rounds)}; K/V pools {kv / 1e6:.1f} MB "
            f"({smi})")
        for t, m in res.per_tenant.items():
            log(f"{tag} (a) {pattern} {t:>6}: {m['completed']}/"
                f"{m['submitted']} done, token latency p50 / p99 "
                f"{m['p50_token_latency_rounds']:.1f} / "
                f"{m['p99_token_latency_rounds']:.1f} rounds, TTFT p50 "
                f"{m['p50_ttft_rounds']:.1f} rounds, goodput "
                f"{m['goodput_tok_s']:.1f} tok/s, preemptions "
                f"{m['preemptions']}")
    paths["llama3.2-3b traffic"] = _since(before)

    # churn rounds: two silver requests decode throughout, a free request
    # of 16 tokens arrives every round and leaves after one token; each
    # round retires one, admits one (K3), drains its promotion (K1) and
    # decodes (K2)
    eng = mt.traffic_engine(cfg, params)
    sched = RequestScheduler(eng, list(mt.TENANTS))
    rng = np.random.default_rng(SEED + 17)
    for _ in range(2):
        sched.submit("silver", rng.integers(2, cfg.vocab_size, size=16)
                     .astype(np.int32), max_new_tokens=64)

    def churn():
        sched.submit("free", rng.integers(2, cfg.vocab_size, size=16)
                     .astype(np.int32), max_new_tokens=1)
        rep = sched.step()
        assert rep.admitted and rep.launches == 1, rep
    for _ in range(3):
        churn()
    torch.cuda.synchronize()
    profile_rounds(churn, rounds=3, tag="llama3.2-3b churn")
    _, reads = tapped(churn)
    checks["(a) a churn round's K2 / K3 calls within their limits"] = \
        set(reads) == {"paged_attention_slab", "flash_attention"} and all(
            r["err"] <= r["limit"] for r in reads.values())
    log(f"{tag} (a) one churn round held against the plain versions: "
        f"{_fmt_reads(reads)}")
    del eng, sched
    torch.cuda.empty_cache()

    # (b) preemption parity: tight, its same-batch twin, roomy
    before = _counts()
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(2, cfg.vocab_size, size=16).astype(np.int32)
               for _ in range(3)]
    small = dict(max_blocks_per_seq=8, max_admit_pages=8, double_buffer=True,
                 device=params.embed.device)

    def engine(**kw):
        return ServingEngine(cfg, params, **small, **kw)

    tight_eng = engine(max_seqs=2, num_slabs=2, spill_pages=8)
    watch = ParkWatch(tight_eng)
    try:
        tight, t_rids, t_log, reads = _preempt_script(tight_eng, prompts,
                                                      tap=True)
    finally:
        watch.close()
    twin, w_rids, w_log, _ = _preempt_script(
        engine(max_seqs=2, num_slabs=2, spill_pages=0), prompts)
    roomy, r_rids, r_log, _ = _preempt_script(engine(max_seqs=8), prompts)
    toks = {name: [s.requests[r].tokens_out for r in rids]
            for name, s, rids in (("tight", tight, t_rids),
                                  ("twin", twin, w_rids),
                                  ("roomy", roomy, r_rids))}
    pre = {name: sum(q.preemptions for q in s.requests.values())
           for name, s in (("tight", tight), ("twin", twin),
                           ("roomy", roomy))}
    demote_round = next((r.round_index for r in tight.reports
                         if r.preempted), None)
    admit_round = next((r.round_index for r in tight.reports
                        if t_rids[2] in r.admitted), None)
    checks.update({
        "(b) tight preempts, twin and roomy do not":
            pre["tight"] >= 1 and pre["twin"] == pre["roomy"] == 0,
        "(b) tight tokens == same-batch twin tokens, bitwise":
            toks["tight"] == toks["twin"]
            and all(len(t) == PARITY_TOKENS for t in toks["tight"]),
        "(b) gold admitted one round after the demotion":
            demote_round is not None and admit_round == demote_round + 1,
        "(b) tight resumes": any(r.resumed for r in tight.reports),
        "(b) parked and resumed blocks bitwise equal to their sources":
            watch.checked >= 4 and watch.bad == 0,
        "(b) <= 1 K1 launch a round (tight, twin, roomy)":
            t_log.agree() and w_log.agree() and r_log.agree(),
        "(b) the tight run's K2 / K3 calls within their limits":
            all(r["err"] <= r["limit"] for r in reads.values())
            and len(reads) == 2,
    })
    diffs = []
    for i, (a, b) in enumerate(zip(toks["tight"], toks["roomy"])):
        if a != b:
            step = next(k for k, (x, y) in enumerate(zip(a, b)) if x != y)
            margin = [m[r_rids[i]] for m in r_log.margins
                      if r_rids[i] in m][step]
            diffs.append(f"request {i} first differs at token {step} "
                         f"(roomy top-2 margin {margin:.4g})")
    log(f"{tag} (b) tight: demotion in round {demote_round}, gold admitted "
        f"in round {admit_round}, {pre['tight']} preemption(s), "
        f"{watch.checked} block copies checked bitwise, K1 per round "
        f"{[g for g, _ in t_log.rounds]}; tokens == same-batch twin: "
        f"{toks['tight'] == toks['twin']}; tokens == roomy (8 slots): "
        f"{toks['tight'] == toks['roomy']}"
        + (f" ({'; '.join(diffs)})" if diffs else "")
        + f"; tight run held against the plain versions: "
        f"{_fmt_reads(reads)} ({smi})")
    del tight_eng, tight, twin, roomy
    torch.cuda.empty_cache()

    # (c) cancel in every state (tests/test_scheduler.py
    # test_cancel_in_every_state, at full width)
    eng = engine(max_seqs=2, num_slabs=2, spill_pages=8)
    sched = RequestScheduler(eng, [TenantSpec("gold", 1),
                                   TenantSpec("free", 0)])
    prng = np.random.default_rng(7)

    def mk(n):
        return prng.integers(2, cfg.vocab_size, size=n).astype(np.int32)
    r_free = [sched.submit("free", mk(9), max_new_tokens=32),
              sched.submit("free", mk(9), max_new_tokens=32)]
    sched.step()
    sched.step()
    r_gold = sched.submit("gold", mk(9), max_new_tokens=4)
    sched.step()
    parked = [r for r in r_free if sched.requests[r].state == "preempted"]
    ok_c = len(parked) == 1
    if ok_c:
        running = next(r for r in r_free if r != parked[0])
        sched.cancel(parked[0])
        ok_c = eng.engine.spill_slots_free == eng.engine.spill_capacity
        sched.cancel(running)
        r_q = sched.submit("free", mk(9), max_new_tokens=4)
        sched.cancel(r_q)
        sched.drain(max_rounds=60)
        torch.cuda.synchronize()
        ok_c = ok_c and all(sched.requests[r].state == "cancelled"
                            for r in (parked[0], running, r_q))
    gold = sched.requests[r_gold]
    checks["(c) cancel: queued, running and parked unwound, gold done"] = \
        ok_c and gold.state == "done" and len(gold.tokens_out) == 4 \
        and eng.cache.seqs == {} \
        and eng.engine.spill_slots_free == eng.engine.spill_capacity
    log(f"{tag} (c) cancel: {len(parked)} parked, gold {gold.state} with "
        f"{len(gold.tokens_out)} tokens, spill slots free "
        f"{eng.engine.spill_slots_free}/{eng.engine.spill_capacity}")
    paths["llama3.2-3b preempt parity"] = _since(before)
    del eng, sched
    torch.cuda.empty_cache()

    # (d) dedup traffic, then the Fig. 3/4 mix on yi-6b
    before = _counts()
    row = mt.run_dedup(rounds=4, seed=SEED, cfg=cfg, params=params)
    paths["llama3.2-3b dedup traffic"] = _since(before)
    torch.cuda.empty_cache()
    checks["(d) dedup traffic: tokens match, <= 1 launch a round"] = \
        row["tokens_match"] and row["max_launches_per_round"] <= 1 \
        and row["pages_shared"] > 0
    log(f"{tag} (d) dedup traffic, {row['tenants']} tenants: resident KV "
        f"{row['kv_bytes_live_on']} B against {row['kv_bytes_live_off']} B "
        f"({row['resident_reduction']:.1%} saved), {row['pages_shared']} "
        f"pages shared, tokens match {row['tokens_match']}, max "
        f"{row['max_launches_per_round']:.0f} launch a round")
    ycfg = get_config(FIG34_ARCH)
    t0 = time.perf_counter()
    yparams = init_params(ycfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    ybytes = sum(p.numel() * p.element_size() for p in yparams.parameters())
    log(f"[{FIG34_ARCH} Fig. 3/4] weights {ybytes / 1e9:.2f} GB made in "
        f"{time.perf_counter() - t0:.1f} s")
    before = _counts()
    rows = mt.run(cfg=ycfg, params=yparams)
    paths[f"{FIG34_ARCH} Fig. 3/4"] = _since(before)
    for r in rows:
        log(f"[{FIG34_ARCH} Fig. 3/4] {r['mix']}: weighted speedup "
            f"RowClone off {r['ws_baseline']:.3f}, on {r['ws_rowclone']:.3f}"
            f" (on / off {r['improvement']:.3f}) ({smi})")
    _, reads = tapped(lambda: mt._run_mix(ycfg, yparams, 1, 3, True))
    checks[f"(d) {FIG34_ARCH}: a mix leg's K2 / K3 calls within their "
           "limits"] = len(reads) == 2 and all(
               r["err"] <= r["limit"] for r in reads.values())
    checks[f"(d) {FIG34_ARCH}: the off legs drain their copies through K1"] \
        = paths[f"{FIG34_ARCH} Fig. 3/4"]["fused_dispatch"] > 0
    log(f"[{FIG34_ARCH} Fig. 3/4] one mix leg (1 copy + 3 plain, RowClone "
        f"on) held against the plain versions: {_fmt_reads(reads)}; K1 "
        f"launches in the sweep {paths[f'{FIG34_ARCH} Fig. 3/4']['fused_dispatch']}")
    del yparams
    torch.cuda.empty_cache()

    log(f"{tag} phase 17 took {time.perf_counter() - t_phase:.1f} s")
    for name, ok in checks.items():
        log(f"{tag} {'ok  ' if ok else 'FAIL'} {name}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"traffic checks failed: {failed}")
    return paths


#: phase 18 (a): the bench's fault_recovery leg (benchmarks/
#: bench_dispatch.py FAULT_*): prompts of FAULT_PROMPT tokens, FAULT_ROUNDS
#: rounds, a launch failure injected at round FAULT_ROUND, a donation error
#: on the third admission at FAULT_READMIT_ROUND, FAULT_CKPT_PAGES spill
#: slots of checkpoint windows, an engine of 8 sequences x FAULT_BLOCKS
FAULT_PROMPT, FAULT_ROUNDS, FAULT_ROUND, FAULT_READMIT_ROUND = 24, 6, 1, 3
FAULT_CKPT_PAGES, FAULT_BLOCKS = 8, 16
#: (b): copy flushes drained after the quiesced snapshot, blocks per flush
SNAP_FLUSHES, SNAP_COPIES = 3, 4
#: (c): copies of the mid-flush abort (above the 512-row top bucket:
#: two chunks) over pools of ABORT_NBLK blocks
ABORT_COPIES, ABORT_NBLK = 600, 1280


class K1Tap:
    """Every K1 call (``ops.fused_dispatch``) inside the block is held
    against its plain version on copies of the same pools, bitwise; the
    kernel call itself is the counted one, the plain version launches no
    kernel."""

    def __enter__(self):
        from repro_torch.kernels import ops, ref
        self.calls, self.bad, self.rows = 0, [], 0
        self._saved = saved = ops.fused_dispatch

        def call(pools, zero_blocks, cmds, *, block_axis=0, primary=None,
                 use_kernel=None):
            want = [p.clone() for p in pools]
            ref.fused_dispatch(want, zero_blocks, cmds,
                               block_axis=block_axis, primary=primary)
            out = saved(pools, zero_blocks, cmds, block_axis=block_axis,
                        primary=primary, use_kernel=True)
            torch.cuda.synchronize()
            self.calls += 1
            self.rows += int((np.asarray(cmds)[:, 0] >= 0).sum())
            if not all(_bitwise_equal(a, b) for a, b in zip(pools, want)):
                self.bad.append(self.calls)
            del want
            return out

        ops.fused_dispatch = call
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.fused_dispatch = self._saved

    def ok(self) -> bool:
        return self.calls > 0 and not self.bad


def _fault_rounds(eng, prompts, plan=None, on_round=None):
    """``bench_dispatch.py _drive_fault_rounds`` at full width: two
    admissions, FAULT_ROUNDS rounds, a launch failure on round
    FAULT_ROUND's next drain and, at FAULT_READMIT_ROUND, a donation
    error on the third admission, then its re-admission.  Returns the
    tokens in admission order, the serve flush's launches a round (-1: it
    failed and recovered) and K1's launches a round (serve flush and
    checkpoint window)."""
    from repro_torch.kernels import ops
    from repro_torch.runtime.fault import InjectedFault
    k1 = ops.KERNEL_COUNTERS["fused_dispatch"]
    order, serve, per_round = [], [], []
    for p in prompts[:2]:
        order.append(eng.add_request(p))
    for r in range(FAULT_ROUNDS):
        if plan is not None and r == FAULT_ROUND:
            plan.launch_failures += (eng.engine.next_flush_index,)
        n0 = k1.n
        if r == FAULT_READMIT_ROUND:
            if plan is not None:
                plan.donation_errors += (eng._admission_ordinal,)
                try:
                    eng.add_request(prompts[2])
                except InjectedFault:
                    pass        # evicted; re-admitted below
            order.append(eng.add_request(prompts[2]))
        if on_round is not None:
            on_round(r)
        eng.decode_round()
        t = eng.last_ticket
        serve.append(int(t.launches) if t is not None else -1)
        per_round.append(k1.n - n0)
    torch.cuda.synchronize()
    return [eng.tokens[s] for s in order if s in eng.tokens], serve, \
        per_round


def phase_recovery(params, smi: str) -> dict:
    """Phase 18: the recovery path (``core/journal.py`` replay,
    ``RowCloneEngine.snapshot`` / ``recover``, ``runtime/fault.py``
    ``FaultPlan``, ``checkpoint/``, ``ServingEngine(fault_plan=,
    auto_recover=, ckpt_*)``) on phase 5's llama3.2-3b weights at full
    width and depth.

    (a) the bench's ``fault_recovery`` leg: an engine of 8 sequences x
        FAULT_BLOCKS blocks (128 blocks of 3,670,016 B per K / V pool) with
        FAULT_CKPT_PAGES checkpoint slots, 3 prompts of FAULT_PROMPT
        tokens, FAULT_ROUNDS rounds, a launch failure at round FAULT_ROUND
        and a donation error on the third admission at round
        FAULT_READMIT_ROUND, against a clean twin with the same checkpoint
        stream: tokens bitwise equal, ``fired`` as injected, the serve
        flush back to <= 1 launch within 2 rounds and at most 1 launch a
        round after, the checkpoint stream still running; ``recover()``'s
        wall ms and K1 launches, the harvest ms a round.  The leg again
        on a fresh engine, with every K2 / K3 call held against its plain
        version (``tapped``): its launches are not the path's.
    (b) a quiesced snapshot round trip on (a)'s engine: a
        ``PoolCheckpoint.drain()`` pass (``async_save=False``, into a
        temporary directory removed afterwards), SNAP_FLUSHES copy flushes,
        ``k`` and ``v`` killed, ``recover(snapshot=latest())``: pools
        restored, the post-snapshot flushes replayed, pools bitwise equal
        to their state before the kill; K1's card ms per replayed flush
        against its byte bound, the ms to save a pass.  A second kill and
        recovery replays the same tables with every K1 call held against
        its plain version (``K1Tap``); its launches are not the path's.
    (c) a mid-flush abort: ABORT_COPIES copies in one flush (two chunks)
        over full-width pools of ABORT_NBLK blocks, a ``midflush_aborts``
        plan: the 512-row prefix journaled ``aborted``, ``recover()``
        re-drains the suffix (tapped), pools bitwise equal to a clean
        twin's.

    Returns the phase's launch counts by kernel."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import CheckpointManager, PoolCheckpoint
    from repro_torch.core.allocator import SubarrayAllocator
    from repro_torch.core.rowclone import RowCloneEngine
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import pool_dead
    from repro_torch.launch.serve import ServingEngine
    from repro_torch.runtime.fault import FaultPlan, InjectedFault
    cfg = params.cfg
    k1 = ops.KERNEL_COUNTERS["fused_dispatch"]
    tag = "[llama3.2-3b recovery]"
    checks = {}
    t_phase = time.perf_counter()
    before = _counts()
    checked = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        rng = np.random.default_rng(SEED)
        prompts = [rng.integers(2, cfg.vocab_size, size=FAULT_PROMPT)
                   .astype(np.int32) for _ in range(3)]

        def engine(plan, sub):
            return ServingEngine(
                cfg, params, max_seqs=MAX_SEQS,
                max_blocks_per_seq=FAULT_BLOCKS, fault_plan=plan,
                auto_recover=plan is not None,
                ckpt_pages=FAULT_CKPT_PAGES, ckpt_dir=f"{tmp}/{sub}")

        # (a) the fault_recovery leg against its clean twin
        twin = engine(None, "twin")
        want, twin_serve, _ = _fault_rounds(twin, prompts)
        del twin
        torch.cuda.empty_cache()
        plan = FaultPlan()
        eng = engine(plan, "fault")
        pool_mb = eng.engine.pools["k"].numel() * 2 / 1e6
        spill_mb = sum(eng.engine.pools[n].numel() * 2
                       for n in ("k_spill", "v_spill")) / 1e6
        recoveries, harvests = [], {}
        rec, harvest = eng.recover, eng.pool_ckpt._harvest

        def timed_recover():
            n0 = k1.n
            t0 = time.perf_counter()
            rep = rec()
            torch.cuda.synchronize()
            recoveries.append(((time.perf_counter() - t0) * 1e3,
                               k1.n - n0, rep))
            return rep

        def timed_harvest():
            t0 = time.perf_counter()
            harvest()
            harvests[rnd[0]] = (time.perf_counter() - t0) * 1e3

        rnd = [0]
        eng.recover = timed_recover
        eng.pool_ckpt._harvest = timed_harvest
        got, serve, per_round = _fault_rounds(
            eng, prompts, plan, on_round=lambda r: rnd.__setitem__(0, r))
        del eng.recover, eng.pool_ckpt._harvest
        rounds_to_recover = next(
            (i for i, n in enumerate(serve[FAULT_ROUND:]) if 0 <= n <= 1),
            len(serve))
        ck = eng.pool_ckpt
        checks.update({
            "(a) tokens bitwise equal to the clean twin's":
                got == want and len(got) == 3,
            "(a) fired == [launch_failure, donation_error]":
                [k for k, _ in plan.fired] == ["launch_failure",
                                               "donation_error"],
            "(a) one evicted admission, re-admitted":
                len(eng.evicted_sids) == 1 and len(recoveries) == 2,
            "(a) rounds_to_recover <= 2": rounds_to_recover <= 2,
            "(a) <= 1 K1 launch a round on the serve flush after recovery":
                max(serve[FAULT_ROUND + 1:]) <= 1
                and min(serve[FAULT_ROUND + 1:]) >= 0,
            "(a) the checkpoint stream still active":
                ck._cursor > 0 or ck.passes > 0,
        })
        log(f"{tag} (a) fault_recovery leg: {MAX_SEQS} x {FAULT_BLOCKS} "
            f"blocks, K / V pools of {pool_mb:.1f} MB each, checkpoint "
            f"spill pools {spill_mb:.1f} MB; serve-flush launches a round "
            f"{serve} (clean twin {twin_serve}), K1 launches a round "
            f"{per_round}; rounds_to_recover {rounds_to_recover}; fired "
            f"{plan.fired}; evicted {eng.evicted_sids}; tokens == clean "
            f"twin: {got == want}; checkpoint cursor {ck._cursor} / "
            f"{ck.nblk}, passes {ck.passes} ({smi})")
        for i, (ms, n, rep) in enumerate(recoveries):
            log(f"{tag} (a) recover() {i + 1}: {ms:.3f} wall ms, {n} K1 "
                f"launches (re-drained {rep.redrained_flushes}, evicted "
                f"rows {rep.evicted_rows}, promotions "
                f"{rep.evicted_promotions}, pools lost {rep.pools_lost}, "
                f"retries {rep.retries}) ({smi})")
        log(f"{tag} (a) harvest ms by round: " + ", ".join(
            f"{r}: {ms:.3f}" for r, ms in sorted(harvests.items()))
            + f" ({2 * FAULT_CKPT_PAGES} blocks, "
            f"{spill_mb:.1f} MB a window) ({smi})")

        # (a) again on a fresh engine, every K2 / K3 call held against its
        # plain version at the leg's shapes (B=8 slab of FAULT_BLOCKS
        # blocks a sequence, prefills of FAULT_PROMPT tokens)
        tplan = FaultPlan()
        teng = engine(tplan, "tapped")
        (tgot, _, _), reads = check_run(
            lambda: tapped(lambda: _fault_rounds(teng, prompts, tplan)),
            checked)
        checks["(a) the leg's K2 / K3 calls within K2_ATOL / K3_ATOL, its "
               "tokens the clean twin's"] = \
            set(reads) == {"paged_attention_slab", "flash_attention"} \
            and all(r["err"] <= r["limit"] for r in reads.values()) \
            and tgot == want
        log(f"{tag} (a) the leg again, held against the plain versions: "
            f"{_fmt_reads(reads)}; tokens == clean twin: {tgot == want}")
        del teng
        torch.cuda.empty_cache()

        # (b) a quiesced snapshot, copy flushes, kill, recover + replay
        rce = eng.engine
        pc = PoolCheckpoint(rce, CheckpointManager(f"{tmp}/quiesced",
                                                   async_save=False),
                            window=FAULT_CKPT_PAGES)
        save_ms = []
        save = pc._save_pass

        def timed_save():
            t0 = time.perf_counter()
            save()
            save_ms.append((time.perf_counter() - t0) * 1e3)

        pc._save_pass = timed_save
        t0 = time.perf_counter()
        pc.drain()
        drain_ms = (time.perf_counter() - t0) * 1e3
        snap = pc.latest()
        live = [b for s in sorted(eng.cache.seqs)
                for b in eng.cache.blocks_of(s)]
        fresh = rce.alloc.alloc(SNAP_FLUSHES * SNAP_COPIES)
        # decode writes the pools outside the allocator's ZI metadata:
        # mark the sources written so the copies move their bytes
        rce.alloc.mark_written(live)
        for i in range(SNAP_FLUSHES):
            dst = fresh[i * SNAP_COPIES:(i + 1) * SNAP_COPIES]
            rce.memcopy([(live[(i + j) % len(live)], d)
                         for j, d in enumerate(dst)])
        torch.cuda.synchronize()
        kept = {n: rce.pools[n].clone() for n in rce.pools}
        replay_recs = rce.journal.since(snap.index)
        group = rce.group
        sizes = [spec.nblk for spec in group]
        layers, page_bytes = int(kept["k"].shape[0]), \
            int(np.prod(kept["k"].shape[2:])) * 2
        bounds = [cost.k1_bytes(r.rows, sizes, group.primary, layers,
                                page_bytes)
                  / cost.HBM_BYTES_PER_S * 1e3 for r in replay_recs]
        for n in ("k", "v"):
            rce.kill_pool(n)
        dead = all(pool_dead(rce.pools[n]) for n in ("k", "v"))
        with K1Events() as timer:
            t0 = time.perf_counter()
            rep = rce.recover(snapshot=snap)
            torch.cuda.synchronize()
            recover_ms = (time.perf_counter() - t0) * 1e3
        replay_ms = [ms for ms, _ in timer.by_round().get(None, [])]
        same = all(_bitwise_equal(rce.pools[n], kept[n]) for n in kept)
        # again, with every replayed K1 call held against its plain version
        for n in ("k", "v"):
            rce.kill_pool(n)
        with K1Tap() as tap_b:
            rep2 = check_run(lambda: rce.recover(snapshot=snap), checked)
        same2 = all(_bitwise_equal(rce.pools[n], kept[n]) for n in kept)
        rce.alloc.free(fresh)
        snap_mb = sum(a.nbytes for a in snap.arrays.values()) / 1e6
        checks.update({
            "(b) pools_restored == (k, v), nothing lost":
                dead and rep.pools_restored == ("k", "v")
                and not rep.pools_lost,
            f"(b) replayed_flushes == {SNAP_FLUSHES}, the flushes after "
            "the snapshot": rep.replayed_flushes == SNAP_FLUSHES
                == len(replay_recs) and rep2.replayed_flushes == SNAP_FLUSHES,
            "(b) pools bitwise equal to their state before the kill":
                same and same2,
            "(b) the replayed K1 calls bitwise equal to the plain version":
                tap_b.ok() and tap_b.calls == SNAP_FLUSHES,
        })
        log(f"{tag} (b) quiesced pass: {pc.nblk // pc.window} windows + "
            f"save in {drain_ms:.1f} ms, save of the pass ({snap_mb:.1f} MB "
            f"on the host, arrays.npz + manifest.json) "
            f"{save_ms[-1]:.1f} ms; snapshot index {snap.index}; "
            f"{SNAP_FLUSHES} copy flushes of {SNAP_COPIES} blocks, k and v "
            f"killed; recover(snapshot) {recover_ms:.1f} wall ms, restored "
            f"{rep.pools_restored}, replayed {rep.replayed_flushes}; pools "
            f"bitwise equal: {same} ({smi})")
        log(f"{tag} (b) K1 per replayed flush: " + "; ".join(
            f"{ms:.4f} card ms against a {b:.4f} ms bound "
            f"({len([x for x in r.rows if x[0] >= 0])} rows)"
            for ms, b, r in zip(replay_ms, bounds, replay_recs))
            + f"; tapped again: {tap_b.calls} calls, {tap_b.rows} rows, "
            f"bitwise {not tap_b.bad} ({smi})")
        del kept, pc, snap, eng, rce
        torch.cuda.empty_cache()

        # (c) a mid-flush abort at full width
        shape = (cfg.num_attn_layers, ABORT_NBLK, 64, cfg.num_kv_heads,
                 cfg.head_dim)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
        base = {n: torch.randn(shape, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for n in ("k", "v")}

        def flat_engine(pools):
            return RowCloneEngine(pools, SubarrayAllocator(ABORT_NBLK, 4),
                                  block_axis=1, enable_zi=False)

        clean = flat_engine({n: p.clone() for n, p in base.items()})
        abort = flat_engine(base)
        pairs = [(2 * i, 2 * i + 1) for i in range(ABORT_COPIES)]
        aplan = FaultPlan(midflush_aborts=(abort.next_flush_index,))
        raised = False
        with aplan.active(abort):
            try:
                abort.memcopy(pairs)
            except InjectedFault:
                raised = True
        prefix = abort.journal.records[-1] if abort.journal.records \
            else None
        suffix = len(abort._aborted[0].suffix) if abort._aborted else 0
        with K1Tap() as tap_c:
            n0 = k1.n
            rep_c = abort.recover()
            k1_c = k1.n - n0
        clean.memcopy(pairs)
        torch.cuda.synchronize()
        same_c = all(_bitwise_equal(abort.pools[n], clean.pools[n])
                     for n in ("k", "v"))
        checks.update({
            "(c) the 512-row prefix journaled aborted, the suffix stashed":
                raised and aplan.fired == [("midflush_abort", 0)]
                and prefix is not None and prefix.aborted
                and len(prefix.rows) == 512
                and suffix == ABORT_COPIES - 512,
            "(c) recover() re-drains the suffix in one K1 launch":
                rep_c.redrained_flushes == 1 and k1_c == 1,
            "(c) pools bitwise equal to the clean twin's": same_c,
            "(c) the re-drain's K1 call bitwise equal to the plain version":
                tap_c.ok() and tap_c.calls == 1,
        })
        log(f"{tag} (c) mid-flush abort: {ABORT_COPIES} copies over pools "
            f"of {ABORT_NBLK} blocks ({shape}), prefix of "
            f"{len(prefix.rows) if prefix else 0} rows journaled aborted "
            f"({prefix.launches if prefix else 0} launch), suffix "
            f"{suffix} rows re-drained in {k1_c} K1 launch; pools bitwise "
            f"equal to the clean twin's: {same_c} ({smi})")
        del clean, abort, base
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    paths = {"llama recovery": {n: c - checked.get(n, 0)
                                for n, c in _since(before).items()}}
    checks["K2 and K3 ran on the path (decode, admission, re-admission)"] = \
        paths["llama recovery"]["paged_attention"] > 0 \
        and paths["llama recovery"]["flash_attention"] > 0
    log(f"{tag} phase 18 took {time.perf_counter() - t_phase:.1f} s")
    for name, ok in checks.items():
        log(f"{tag} {'ok  ' if ok else 'FAIL'} {name}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"recovery checks failed: {failed}")
    return paths


# ---------------------------------------------------------------------------
# phase 19: the observability half (sanitizer, spans, metrics, autotune)
# ---------------------------------------------------------------------------

#: (a) prompts: two admitted before the rounds (the first forked into 2),
#: one in the last round; a sequence's block count; the rounds
OBS_PROMPTS, OBS_BLOCKS, OBS_ROUNDS = (100, 128, 60), 16, 4
#: (d) rounds (and flushes) timed with observability on and off, each
OBS_COST_REPS = 24
#: (e) the flush matrix's pools: llama3.2-3b's layer-stacked K/V pages; a
#: flush of BIG_ROWS rows over BIG_NBLK blocks pads to one 1,024-row table
#: under the bucket set (16, 64, 256, 1024), two chunks under the default
SWEEP_NBLK, BIG_NBLK, BIG_ROWS = 1024, 2048, 600


def _obs_script(eng, prompts, tap=False):
    """Phase 19's serving script: admit two prompts, one round, fork the
    first into 2 (after its promotions drained, as phase 5 does), the rest
    of OBS_ROUNDS rounds, then admit the third and run one more round.
    With ``tap`` every K2 / K3 call of the script is held against its
    plain version.  Returns the tokens in admission order, K1 launches a
    round, the tickets of the rounds' flushes that drained rows and the
    K2 / K3 reads (empty without ``tap``)."""
    from repro_torch.kernels import ops
    k1 = ops.KERNEL_COUNTERS["fused_dispatch"]
    per_round, tickets = [], []

    def one_round():
        n0 = k1.n
        eng.decode_round()
        per_round.append(k1.n - n0)
        tickets.append(eng.last_ticket)

    def script():
        sids = [eng.add_request(p) for p in prompts[:2]]
        for r in range(OBS_ROUNDS):
            if r == 1:
                sids += eng.fork(sids[0], 1)
            one_round()
        sids.append(eng.add_request(prompts[2]))
        one_round()
        return sids

    sids, reads = tapped(script) if tap else (script(), {})
    torch.cuda.synchronize()
    drained = [t for t in tickets if t is not None and t.commands]
    return [eng.tokens[s] for s in sids], per_round, drained, reads


def _journal_counts(records):
    """Rows by opcode name, spacers and launches of journal records."""
    from repro_torch.core.opcodes import OPCODE_NAMES
    rows, spacers = {}, 0
    for rec in records:
        for op, _s, _d in rec.rows:
            if op < 0:
                spacers += 1
            else:
                name = OPCODE_NAMES[int(op)]
                rows[name] = rows.get(name, 0) + 1
    return rows, spacers, sum(r.launches for r in records)


def phase_observability(params, smi: str) -> dict:
    """Phase 19: the observability half (``core/sanitizer.py``,
    ``obs/trace.py``, the core's ``drain.*`` / ``queue.*`` /
    ``engine.bytes_*`` series, ``obs/autotune.py`` and
    ``launch/autotune.py``) on phase 5's llama3.2-3b weights at full
    width and depth.

    (a) a ``ServingEngine`` (8 sequences x OBS_BLOCKS blocks) whose
        ``RowCloneEngine`` gets a sanitizer from ``REPRO_SANITIZE=1`` at
        construction, ``shadow_every=1``, runs the twin's script (two
        admissions, a fork, OBS_ROUNDS rounds, a third admission and one
        more round) with every K2 / K3 call held against its plain
        version (``tapped``), so every prefill and decode shape of the
        path is held.  It is a check run: its launches are left out of
        the path's count.  Every report ok, ``tables_checked ==
        shadow_runs ==`` the K1 launches of the run (each shadow drain is
        the plain version on host copies, bit for bit), tokens equal to
        an unsanitized twin's, <= 1 K1 launch a round on both.  Then a
        planted K1 whose output differs in one block: the flush raises
        ``SanitizerError`` with only a ``shadow-diff`` finding.
    (b) over the twin: ``drain.rows`` by opcode, ``drain.spacer_rows`` and
        ``drain.launches`` equal to its journal records (and the launches
        to the tickets' and K1's counter), ``queue.enqueued`` to the
        tickets' commands, one histogram sample a flush.
    (c) an admission and its round under ``torch.profiler``: ``flush``
        ranges with ``drain`` nested inside, the K1 kernel attributed to a
        ``drain`` range; ``FlushTicket.timing.drain_us`` (host wall-clock
        around an asynchronous launch) printed beside K1's device time
        from the same trace.
    (d) what observability costs: OBS_COST_REPS rounds (and 64-row
        flushes over (e)'s pools) each with tracing and metrics on and
        off, in turns; medians and spreads, and the host cost of one
        labeled ``inc()``.  Nothing is gated on these times.
    (e) ``launch/autotune.py``'s flush matrix (the reference's bucket
        sets, batches and reps) over full-width pools (two ``(28,
        SWEEP_NBLK, 64, 8, 128)`` bf16 pools), a short ring sweep with
        phase 5's weights, into a temporary directory: 1.0 launches a
        flush under every bucket set; each set's batches, and a BIG_ROWS
        table over BIG_NBLK-block pools (one 1,024-row table under (16,
        64, 256, 1024)), drained once more with every K1 call held against
        its plain version (``K1Tap``); the profile written, read back,
        loaded by an engine on the card, and ServingEngine's ring
        resolved kwarg > profile > policy.

    Returns the phase's launch counts by kernel."""
    import dataclasses
    import os
    import shutil
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import cmdqueue
    from repro_torch.core.allocator import SubarrayAllocator
    from repro_torch.core.rowclone import RowCloneEngine
    from repro_torch.core.sanitizer import SanitizerError
    from repro_torch.kernels import ops
    from repro_torch.launch import autotune
    from repro_torch.launch.serve import ServingEngine
    from repro_torch.obs import autotune as obs_autotune
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import trace
    cfg = params.cfg
    k1 = ops.KERNEL_COUNTERS["fused_dispatch"]
    tag = "[llama3.2-3b observability]"
    checks = {}
    t_phase = time.perf_counter()
    before = _counts()
    checked = {}
    rng = np.random.default_rng(SEED + 19)
    prompts = [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32)
               for n in OBS_PROMPTS + (OBS_PROMPTS[0],)]

    def engine():
        return ServingEngine(cfg, params, max_seqs=MAX_SEQS,
                             max_blocks_per_seq=OBS_BLOCKS)

    # (b)'s twin first, on a clean registry
    obs_metrics.reset()
    trace.reset_spans()
    twin = engine()
    assert twin.engine.sanitizer is None
    n0 = k1.n
    want, twin_rounds, tickets, _ = _obs_script(twin, prompts)
    twin_k1 = k1.n - n0
    reg = obs_metrics.registry()
    recs = [r for r in twin.engine.journal.records if not r.aborted]
    j_rows, j_spacers, j_launches = _journal_counts(recs)
    got_rows = {}
    for labels, v in reg.series("drain.rows").items():
        op = dict(labels)["opcode"]
        got_rows[op] = got_rows.get(op, 0) + int(v)
    got_spacers = int(sum(reg.series("drain.spacer_rows").values()))
    got_launches = int(sum(reg.series("drain.launches").values()))
    enqueued = int(sum(reg.series("queue.enqueued").values()))
    hist_n = {k: len(v) for k, v in reg.hists.items()
              if k[0] in ("drain.flush_us", "drain.table_len")}
    checks.update({
        "(b) drain.rows by opcode == the journal records' rows":
            got_rows == j_rows and sum(j_rows.values()) > 0,
        "(b) drain.spacer_rows == the journal's spacers":
            got_spacers == j_spacers,
        "(b) drain.launches == the journal's == the tickets' == K1's":
            got_launches == j_launches == twin_k1
            == sum(t.launches for t in tickets),
        "(b) queue.enqueued == the tickets' commands":
            enqueued == sum(t.commands for t in tickets),
        "(b) one drain.flush_us and one drain.table_len sample a flush":
            sum(hist_n.values()) == 2 * len(recs) > 0,
        "(b) every ticket carries a FlushTiming":
            all(t.timing is not None and t.timing.launches == t.launches
                for t in tickets),
    })
    moved = {}
    for labels, v in reg.series("engine.bytes_moved").items():
        mech = dict(labels)["mechanism"]
        moved[mech] = moved.get(mech, 0) + int(v)
    log(f"{tag} (b) unsanitized twin: K1 launches a round {twin_rounds}, "
        f"{len(recs)} flushes; drain.rows {got_rows} (journal {j_rows}), "
        f"spacers {got_spacers} ({j_spacers}), drain.launches "
        f"{got_launches} (journal {j_launches}, K1 {twin_k1}), "
        f"queue.enqueued {enqueued} (tickets "
        f"{sum(t.commands for t in tickets)}); engine.bytes_moved by "
        f"mechanism {moved}; "
        f"timings (residency / drain us, table) " + ", ".join(
            f"{t.timing.queue_residency_us:.1f} / {t.timing.drain_us:.1f}, "
            f"{t.timing.table_len}" for t in tickets))

    # (a) the sanitized engine
    os.environ["REPRO_SANITIZE"] = "1"
    try:
        eng = engine()
    finally:
        os.environ.pop("REPRO_SANITIZE", None)
    san = eng.engine.sanitizer
    n0 = k1.n
    t0 = time.perf_counter()
    got, san_rounds, _, reads = check_run(
        lambda: _obs_script(eng, prompts, tap=True), checked)
    san_s = time.perf_counter() - t0
    san_k1 = k1.n - n0
    pool_mb = sum(p.numel() * p.element_size()
                  for p in eng.engine.pools.values()) / 1e6
    checks.update({
        "(a) the sanitizer attached by REPRO_SANITIZE=1, shadow_every=1":
            san is not None and san.shadow_every == 1,
        "(a) every sanitizer report ok":
            bool(san.reports) and all(r.ok for r in san.reports),
        "(a) tables_checked == shadow_runs == the run's K1 launches":
            san.tables_checked == san.shadow_runs == san_k1 > 0,
        "(a) tokens equal to the unsanitized twin's":
            got == want and len(got) == 4,
        "(a) <= 1 K1 launch a round, sanitized and twin":
            max(san_rounds) <= 1 and max(twin_rounds) <= 1
            and san_rounds == twin_rounds,
        "(a) the script's K2 / K3 calls within K2_ATOL / K3_ATOL":
            set(reads) == {"paged_attention_slab", "flash_attention"}
            and all(r["err"] <= r["limit"] for r in reads.values()),
    })
    log(f"{tag} (a) sanitized engine ({pool_mb:.1f} MB of pools, every "
        f"chunk shadowed): K1 launches a round {san_rounds} (twin "
        f"{twin_rounds}); tables_checked {san.tables_checked}, shadow_runs "
        f"{san.shadow_runs}, K1 launches {san_k1}; tokens == twin: "
        f"{got == want}; script {san_s:.1f} s with the shadow copies; the "
        f"script's K2 / K3 calls: {_fmt_reads(reads)} ({smi})")
    # the planted fault: a K1 whose output differs in one block
    real = ops.fused_dispatch

    def bad(pools, zero_blocks, cmds, **kw):
        out = real(pools, zero_blocks, cmds, **kw)
        pools[0].select(1, 2).view(torch.int16).bitwise_xor_(1)
        return out

    rce = eng.engine
    src = rce.alloc.alloc(1)
    dst = rce.alloc.alloc(1)
    rce.alloc.mark_written(src)
    # the error's message and findings only: its traceback would keep
    # the engine's pools alive
    caught, found = "NOT raised", None
    ops.fused_dispatch = bad
    try:
        check_run(lambda: rce.memcopy([(src[0], dst[0])]), checked)
    except SanitizerError as e:
        caught = str(e).replace("\n", " | ")
        found = {f.check for f in e.report.findings}
    finally:
        ops.fused_dispatch = real
    checks["(a) a planted K1 fault raises SanitizerError, shadow-diff only"] \
        = found == {"shadow-diff"}
    log(f"{tag} (a) planted fault: {caught}")
    del eng, rce, san

    # (c) an admission and its round under torch.profiler (the trace
    # missed K1 where it was the window's first kernel)
    torch.cuda.synchronize()
    trace.reset_spans()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        twin.add_request(prompts[3])
        twin.decode_round()
        torch.cuda.synchronize()
    cpu = torch.autograd.DeviceType.CPU
    cuda = torch.autograd.DeviceType.CUDA
    # the trace's raw events: a kernel and the runtime call that launched
    # it share a correlation id, so a kernel lies in a range when its
    # launch call does
    kev = prof.profiler.kineto_results.events()
    ranges = {n: [(e.start_ns(), e.end_ns()) for e in kev
                  if e.name() == n and e.device_type() == cpu]
              for n in ("flush", "drain")}
    nested = [d for d in ranges["drain"] if any(
        f[0] <= d[0] and d[1] <= f[1] for f in ranges["flush"])]
    launch_at = {e.correlation_id(): e.start_ns() for e in kev
                 if e.device_type() == cpu and "LaunchKernel" in e.name()}
    k1_ev = [e for e in kev if e.device_type() == cuda
             and "drain_kernel" in e.name()]
    in_drain = [e for e in k1_ev if any(
        a <= launch_at.get(e.correlation_id(), -1) <= b
        for a, b in ranges["drain"])]
    k1_us = sum(e.duration_ns() for e in k1_ev) / 1e3
    timing = twin.last_ticket.timing
    checks.update({
        "(c) flush ranges with a drain range nested inside":
            bool(ranges["flush"]) and len(nested) == len(ranges["drain"])
            >= 1,
        "(c) the K1 kernel launched inside a drain range":
            len(in_drain) == len(k1_ev) == twin.last_ticket.launches == 1,
        "(c) the span records: flush -> drain": [
            (r.name, r.depth) for r in trace.spans()
            if r.name in ("flush", "drain")] == [("flush", 0), ("drain", 1)],
    })
    log(f"{tag} (c) profiled round: {len(ranges['flush'])} flush "
        f"range(s), {len(ranges['drain'])} drain range(s) ({len(nested)} "
        f"nested in a flush), K1 kernels {len(k1_ev)}, launched inside a "
        f"drain range {len(in_drain)}; FlushTicket.timing.drain_us "
        f"{timing.drain_us:.1f} us (host wall-clock around the "
        f"asynchronous launch) beside K1's device time {k1_us:.1f} us in "
        f"the same trace; queue residency "
        f"{timing.queue_residency_us:.1f} us, table {timing.table_len} "
        f"rows ({smi})")
    if len(in_drain) != 1:
        dev = sorted({e.name()[:60] for e in kev if e.device_type() == cuda})
        log(f"{tag} (c) device events: {len(dev)} names, {dev[:25]}; "
            f"launch calls {len(launch_at)}; K1 correlation ids "
            f"{[e.correlation_id() for e in k1_ev]}; launch calls in the "
            f"drain range: {[(c, t) for c, t in launch_at.items() if any(a <= t <= b for a, b in ranges['drain'])]}")

    # (e)'s pools: two full-width layer-stacked pools
    gen = torch.Generator(device="cuda").manual_seed(SEED + 190)
    L, KVH, D = cfg.num_attn_layers, cfg.num_kv_heads, cfg.head_dim

    def wide_engine(nblk=SWEEP_NBLK):
        pools = {n: torch.randn((L, nblk, 64, KVH, D), generator=gen,
                                device="cuda", dtype=torch.bfloat16)
                 for n in ("k", "v")}
        return RowCloneEngine(pools, SubarrayAllocator(nblk, 4,
                                                       reserved_zero_per_slab=1),
                              block_axis=1)

    # (d) observability on and off, in turns
    flat = wide_engine()

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    cost = {("round", True): [], ("round", False): [],
            ("flush", True): [], ("flush", False): []}
    for i in range(2 * OBS_COST_REPS):
        on = i % 2 == 0
        prev_m = obs_metrics.set_metrics_enabled(on)
        prev_t = trace.set_tracing(on)
        try:
            cost[("round", on)].append(timed(twin.decode_round))
            cost[("flush", on)].append(timed(
                lambda: autotune.flush_once(flat, 64, i)))
        finally:
            obs_metrics.set_metrics_enabled(prev_m)
            trace.set_tracing(prev_t)
    t0 = time.perf_counter()
    for _ in range(10000):
        obs_metrics.inc("queue.enqueued", stream="serve",
                        opcode="cross_pool_copy")
    inc_us = (time.perf_counter() - t0) * 1e6 / 10000
    for what in ("round", "flush"):
        s_on = obs_metrics.summarize(cost[(what, True)])
        s_off = obs_metrics.summarize(cost[(what, False)])
        kind = (f"decode rounds of {len(twin.cache.seqs)} sequences"
                if what == "round" else "64-row flushes over (e)'s pools")
        plural = "flushes" if what == "flush" else "rounds"
        log(f"{tag} (d) {plural} ({kind}), "
            f"{OBS_COST_REPS} each in turns: on p50 {s_on['p50']:.3f} ms "
            f"(min {s_on['min']:.3f}, p90 {s_on['p90']:.3f}, max "
            f"{s_on['max']:.3f}); off p50 {s_off['p50']:.3f} ms (min "
            f"{s_off['min']:.3f}, p90 {s_off['p90']:.3f}, max "
            f"{s_off['max']:.3f}) ({smi})")
    log(f"{tag} (d) one labeled inc() {inc_us:.3f} us on the host; a "
        f"64-row flush enqueues 64 rows ({smi})")
    del twin, flat

    # (e) the card sweep, into a temporary directory
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tuned_")
    env_keys = ("REPRO_TUNED_DIR", "REPRO_NO_TUNED")
    env_prev = {k: os.environ.get(k) for k in env_keys}
    try:
        # the sweep measures raw configurations (tune sets REPRO_NO_TUNED
        # around it); every engine built after it reads the new profile
        os.environ.pop("REPRO_NO_TUNED", None)
        os.environ["REPRO_TUNED_DIR"] = tmp
        t0 = time.perf_counter()
        n0 = k1.n
        prof_e = autotune.tune(out_dir=tmp, device="cuda",
                               make_engine=wide_engine, model=params)
        sweep_s = time.perf_counter() - t0
        rows = prof_e.swept["flush"]["rows"]
        for r in rows + prof_e.swept.get("ring", {}).get("rows", []):
            log(f"{tag} (e) {json.dumps(r)}")
        # every bucket set once more, each K1 call held against its plain
        # version; and one table of BIG_ROWS rows
        taps = {}
        for buckets in autotune.BUCKET_SETS:
            with autotune.buckets_installed(buckets), K1Tap() as tap:
                def drain_all():
                    out = []
                    for batch in autotune.BATCHES:
                        e = wide_engine()
                        autotune.flush_once(e, batch, 0)
                        out.append((batch, e.last_drain_timing))
                        del e
                    big = wide_engine(nblk=BIG_NBLK)
                    autotune.flush_once(big, BIG_ROWS, 0)
                    out.append((BIG_ROWS, big.last_drain_timing))
                    return out
                timings = check_run(drain_all, checked)
            top = buckets[-1]
            taps[buckets] = dict(
                bitwise=tap.ok(), calls=tap.calls,
                drains=[(b, t.table_len, t.launches) for b, t in timings],
                fit=tap.calls == sum(t.launches for _, t in timings)
                and all(t.launches == -(-b // top) for b, t in timings))
        big_1024 = [(n, ln) for b, n, ln in
                    taps[(16, 64, 256, 1024)]["drains"] if b == BIG_ROWS]
        # the profile round trip, and kwarg > profile > policy for the
        # serving ring on the card
        loaded = obs_autotune.load_profile(prof_e.backend)
        loaded_by_engine = wide_engine(nblk=64).profile == prof_e
        tight = dataclasses.replace(prof_e, ring_capacity=5)
        obs_autotune.save_profile(tight, directory=tmp)
        srv = ServingEngine(cfg, params, max_seqs=2, max_blocks_per_seq=4)
        srv_kw = ServingEngine(cfg, params, max_seqs=2, max_blocks_per_seq=4,
                               max_admit_pages=3)
        os.environ["REPRO_NO_TUNED"] = "1"
        srv_def = ServingEngine(cfg, params, max_seqs=2, max_blocks_per_seq=4)
        precedence = (srv.ring_capacity, srv_kw.ring_capacity,
                      srv_def.ring_capacity, srv_def.engine.profile is None)
        del srv, srv_kw, srv_def
        checks.update({
            "(e) 1.0 K1 launches a flush under every bucket set":
                len(rows) == len(autotune.BUCKET_SETS)
                and all(r["launches_per_flush"] == 1.0 for r in rows),
            "(e) every bucket set's K1 calls bitwise equal to the plain "
            "version, launches == ceil(rows / top bucket)":
                all(t["bitwise"] and t["fit"] for t in taps.values()),
            "(e) a 1,024-row table under (16, 64, 256, 1024), one launch":
                big_1024 == [(1024, 1)],
            "(e) the profile written (backend cuda), read back equal, "
            "loaded by an engine":
                prof_e.backend == "cuda" and loaded == prof_e
                and loaded_by_engine,
            "(e) the serving ring: kwarg > profile > policy on the card":
                precedence == (5, 3, 4, True),
            "(e) the default buckets restored":
                cmdqueue.get_buckets() == cmdqueue.DEFAULT_BUCKETS,
        })
        log(f"{tag} (e) sweep {sweep_s:.1f} s, {k1.n - n0} K1 launches; "
            f"winner buckets {list(prof_e.buckets)}, ring "
            f"{prof_e.ring_capacity}, {prof_e.us_per_flush:.1f} us/flush "
            f"against the default's {prof_e.baseline_us_per_flush:.1f} "
            f"({smi}); the serving ring (profile, kwarg, policy; no profile "
            f"loaded under REPRO_NO_TUNED) {precedence}; taps: " + "; ".join(
                f"{list(b)}: {t['calls']} calls, bitwise {t['bitwise']}, "
                f"(rows, table, launches) {t['drains']}"
                for b, t in taps.items()))
    finally:
        cmdqueue.set_buckets(None)
        for k, v in env_prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)
    paths = {"llama observability": {n: c - checked.get(n, 0)
                                     for n, c in _since(before).items()}}
    p = paths["llama observability"]
    checks["K1, K2 and K3 ran on the path"] = \
        p["fused_dispatch"] > 0 and p["paged_attention"] > 0 \
        and p["flash_attention"] > 0
    log(f"{tag} phase 19 took {time.perf_counter() - t_phase:.1f} s")
    for name, ok in checks.items():
        log(f"{tag} {'ok  ' if ok else 'FAIL'} {name}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"observability checks failed: {failed}")
    return paths


# ---------------------------------------------------------------------------
# phase 20: K7 and the sharded bulk-movement drain over a rank mesh
# ---------------------------------------------------------------------------

#: phase 20's block: phase 5's K / V page (64 tokens x 8 KV heads x 128
#: dims, bf16) over llama3.2-3b's 28 layers, block axis 1
MESH_LAYERS, MESH_PAGE = 28, (64, 8, 128)
#: blocks of each K / V pool of (b)'s engines (a multiple of 8 ranks) and
#: slots of their staging ring
MESH_NBLK, MESH_RING = 256, 32
#: property programs of (b), and their instructions
MESH_PROGRAMS, MESH_INSTR = 3, 12
#: the instruction kinds of tests/test_dispatch_properties.py gen_program
MESH_KINDS = ("copy", "copy", "zero", "lazy", "cross", "cross", "war",
              "bit", "bit")
MESH_BIT_POOLS = ("k", "v", "k_stage", "v_stage")
MESH_CROSS = (("k", "v"), ("v", "k"), ("k_stage", "k"), ("v_stage", "v"),
              ("k", "k_stage"), ("v", "v_stage"), ("k_stage", "v"),
              ("k_stage", "v_stage"))


def _mesh_program(rng, nblk: int, snblk: int, n_instr: int) -> list:
    """A random instruction stream in ``mechanisms.drive``'s format, drawn
    as ``gen_program`` draws it (duplicate destinations force hazard
    flushes, adjacent write-after-read pairs, in-place bitwise rows,
    staging traffic both ways); its ``war`` kind becomes a copy followed
    by a zero or a rewrite of the copied block."""
    sizes = {"k": nblk, "v": nblk, "k_stage": snblk, "v_stage": snblk}
    prog = []
    for _ in range(n_instr):
        kind = rng.choice(MESH_KINDS)
        if kind == "copy":
            prog.append(["copy", [[rng.randrange(nblk), rng.randrange(nblk)]
                                  for _ in range(rng.randint(1, 6))]])
        elif kind in ("zero", "lazy"):
            prog.append([kind, [rng.randrange(nblk)
                                for _ in range(rng.randint(1, 4))]])
        elif kind == "war":
            a, b, c = (rng.randrange(nblk) for _ in range(3))
            if rng.random() < 0.5:
                prog.append(["copy", [[a, b], [c, a]]])
            else:
                prog += [["copy", [[a, b]]], ["zero", [a]]]
        elif kind == "bit":
            op = rng.choice(["and", "or", "not"])
            n = rng.randint(1, 4)
            width = 2 if op == "not" else 3
            if rng.random() < 0.5:
                prog.append(["bit", op, [[rng.randrange(nblk)
                                          for _ in range(width)]
                                         for _ in range(n)], "int"])
            else:
                prog.append(["bit", op, [[[p, rng.randrange(sizes[p])]
                                          for p in (rng.choice(MESH_BIT_POOLS)
                                                    for _ in range(width))]
                                         for _ in range(n)], "ref"])
        else:
            sp, dp = rng.choice(MESH_CROSS)
            prog.append(["cross", [[rng.randrange(sizes[sp]),
                                    rng.randrange(sizes[dp])]
                                   for _ in range(rng.randint(1, 4))],
                         sp, dp])
    return prog


def _mesh_block(n):
    """``n`` zero-filled blocks' shape (block axis 1)."""
    return (MESH_LAYERS, n) + MESH_PAGE


def _mesh_engine(pools, mesh, use_fused=True, ring_replicated=False,
                 num_slabs=4):
    """An engine over copies of ``pools`` (K / V and their staging ring):
    one device (``mesh=None``) or a rank mesh; the ring replicated on
    every rank with ``ring_replicated``."""
    from repro_torch.core.allocator import SubarrayAllocator
    from repro_torch.core.poolspec import PoolGroup, PoolSpec
    from repro_torch.core.rowclone import RowCloneEngine
    nblk, snblk = pools["k"].shape[1], pools["k_stage"].shape[1]
    blk = (MESH_LAYERS,) + MESH_PAGE
    hint = () if ring_replicated else None
    group = PoolGroup([
        PoolSpec("k", nblk, blk, torch.bfloat16),
        PoolSpec("v", nblk, blk, torch.bfloat16),
        PoolSpec("k_stage", snblk, blk, torch.bfloat16, role="staging",
                 paired="k", sharding=hint),
        PoolSpec("v_stage", snblk, blk, torch.bfloat16, role="staging",
                 paired="v", sharding=hint)])
    eng = RowCloneEngine({n: p.clone() for n, p in pools.items()},
                         SubarrayAllocator(nblk, num_slabs), mesh=mesh,
                         block_axis=1, use_fused=use_fused, group=group,
                         max_requests=64)
    eng.alloc.mark_written(list(range(nblk)))
    return eng


def _mesh_pools(gen, nblk, snblk):
    return {n: _bf16_pool(_mesh_block(nb), gen) for n, nb in
            (("k", nblk), ("v", nblk), ("k_stage", snblk),
             ("v_stage", snblk))}


def _same_pools(a, b) -> list:
    """Names of the pools of engines ``a`` and ``b`` that differ."""
    return [n for n in a.pools if not _bitwise_equal(a.pools[n], b.pools[n])]


def _k7_case(gen, rng, n, ss=32):
    """K7's inputs on ``n`` ranks of the card: full-width slabs of ``ss``
    blocks and (n, 2n - 1, 3) rows at every hop -(n-1) .. n-1 with skip
    rows (sources in each slab's low half, destinations in its high
    half, one writer a block)."""
    slabs = [_bf16_pool(_mesh_block(ss), gen) for _ in range(n)]
    ids = np.full((n, 2 * n - 1, 3), -1, np.int64)
    free = {r: list(rng.permutation(np.arange(ss // 2, ss)))
            for r in range(n)}
    for my in range(n):
        for j, hop in enumerate(range(-(n - 1), n)):
            tgt = (my + hop + n) % n
            if rng.random() < 0.2 or not free[tgt]:
                continue
            ids[my, j] = (rng.integers(0, ss // 2), free[tgt].pop(), hop)
    return slabs, ids


def _k7_library(slabs, ids):
    """The library's answer to one K7 call: ``index_copy_`` of an
    ``index_select`` for each (sender, receiver) pair."""
    n = len(slabs)
    groups = {}
    for my in range(n):
        for s, d, hop in ids[my][ids[my, :, 0] >= 0].tolist():
            groups.setdefault((my, (my + hop + n) % n), []).append((s, d))
    calls = [(slabs[my], slabs[tgt],
              torch.tensor([s for s, _ in prs], device="cuda"),
              torch.tensor([d for _, d in prs], device="cuda"))
             for (my, tgt), prs in groups.items()]

    def run():
        for src, dst, si, di in calls:
            dst.index_copy_(1, di, src.index_select(1, si))
    return run


#: phase 20 (a): random calls on which the library's K7 plan is held
#: against the Python statement, and rows a rank of the leg above the
#: launch parameters' room
K7_PLAN_CALLS, K7_WIDE_ROWS = 1000, 40


def _k7_plan_call(rng):
    """One random K7 call over fake slab records for the plan check:
    ``(records, n, rows, card, layers, page_bytes)``.  1-8 ranks, 1-3
    tables drawn from a few records (shared between tables and sides, one
    in ten 8 bytes off, on cards 0 and 1); rows in range, then perhaps one
    pushed outside the call, a copied destination (WAW) or a source on
    another row's destination (RAW); one call in twenty has 170-400 rows
    that clash nowhere (above the launch parameters' room)."""
    n = int(rng.choice([1, 2, 4, 8]))
    nt = int(rng.integers(1, 4))
    page = int(rng.choice([102, 4096, 131072]))
    layers = int(rng.choice([1, 28]))
    wide = rng.random() < 0.05
    pool = []
    for i in range(int(rng.integers(1, 2 * n + 2))):
        base = (1 << 44) + i * (1 << 36) + (8 if rng.random() < 0.1 else 0)
        pool.append((base, 1024 if wide else int(rng.integers(2, 64)),
                     int(rng.integers(2))))
    rec = np.zeros((nt, 2, n, 3), np.int64)
    for t in range(nt):
        src = rng.integers(0, len(pool), n)
        dst = src if rng.random() < 0.4 else rng.integers(0, len(pool), n)
        rec[t, 0] = [pool[i] for i in src]
        rec[t, 1] = [pool[i] for i in dst]
    if wide:
        m = int(rng.integers(170, 401))
        rows = np.array([[int(rng.integers(nt)), i % n, i, 512 + i,
                          int(rng.integers(-(n - 1), n))] for i in range(m)],
                        np.int64)
        return rec, n, rows, int(rng.integers(2)), layers, page
    rows = []
    for _ in range(int(rng.integers(0, 4 * n + 4))):
        t, my = int(rng.integers(nt)), int(rng.integers(n))
        hop = int(rng.integers(-(n - 1), n))
        tgt = (my + hop + n) % n
        rows.append([t, my, int(rng.integers(rec[t, 0, my, 1])),
                     int(rng.integers(rec[t, 1, tgt, 1])), hop])
    rows = np.asarray(rows, np.int64).reshape(-1, 5)
    if len(rows):
        i, j = rng.integers(len(rows), size=2)
        what = rng.random()
        if what < 0.15:
            rows[i, int(rng.integers(5))] = int(rng.choice([-n, -1, n, 99]))
        elif what < 0.3:
            rows[j] = rows[i]
        elif what < 0.45:
            t, my, _, d, hop = (int(x) for x in rows[i])
            tgt = (my + hop + n) % n
            rows[j] = (t, tgt, d, rng.integers(rec[t, 1, tgt, 1]), 0)
    return rec, n, rows, int(rng.integers(2)), layers, page


def _k7_plan_check(rng, sms: int):
    """(calls whose library plan equals the Python statement, code counts
    by name, the first differing call)."""
    from repro_torch.kernels import psm_transfer as k7
    names = {0: "kept", k7.OUTSIDE: "outside", k7.BLOCK_OUTSIDE: "block",
             k7.WAW: "waw", k7.RAW: "raw"}
    same, counts, first_bad = 0, {}, None
    for i in range(K7_PLAN_CALLS):
        rec, n, rows, card, layers, page = _k7_plan_call(rng)
        kw = dict(layers=layers, page_bytes=page, sms=sms)
        got = k7.plan(rec, n, rows, card, **kw)
        want = k7.plan_rows(rec, n, rows, card, **kw)
        ok = got[0] == want[0] and np.array_equal(got[1], want[1]) \
            and np.array_equal(got[2], want[2])
        same += ok
        key = names.get(want[0], str(want[0]))
        if want[0] == 0 and want[2][7]:
            key = "kept above the parameters' room"
        counts[key] = counts.get(key, 0) + 1
        if not ok and first_bad is None:
            first_bad = (i, got[0], want[0], got[2].tolist(),
                         want[2].tolist())
    return same, counts, first_bad


def _k7_leg(slabs, ids, block_axis: int, scrub):
    """K7 once against its plain version (bitwise, one launch; the slabs
    are moved in place) and timed: (bitwise, launches, the call's ``out``
    words, card ms, (device ms, launches recorded), host us a call)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import psm_transfer as k7
    want = ops.psm_transfer([s.clone() for s in slabs], ids,
                            block_axis=block_axis, use_kernel=False)
    # in place: a clone would not keep a slab's base alignment
    n0 = k7.COUNTER.n
    ops.psm_transfer(slabs, ids, block_axis=block_axis)
    torch.cuda.synchronize()
    launches = k7.COUNTER.n - n0
    out = k7.last_out.tolist()
    ok = all(_bitwise_equal(g, w) for g, w in zip(slabs, want))
    del want
    run = lambda: ops.psm_transfer(slabs, ids, block_axis=block_axis)
    ms = time_ms(run, scrub=scrub)
    dev = device_ms(run, key="psm_kernel", reps=10)
    return ok, launches, out, ms, dev, host_call_us(run)


def host_call_us(fn, calls: int = 20, batches: int = 3) -> float:
    """The host's us a call of ``fn`` (a launch that returns before the
    card is done): ``calls`` calls back to back, the card synchronised
    before and after each batch; the least of ``batches``."""
    best = []
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return min(best)


def _route(out) -> str:
    return (f"route {'bulk' if out[5] else 'word'} ({out[6]}-byte words), "
            f"{out[0]} rows{' through the row buffer' if out[7] else ''}, "
            f"items {out[1]}, grid {out[2]}, chunk {out[3]} B")


def mesh_peer_leg(gen, rng, tag: str) -> dict:
    """Phase 20 (e): K7 with its ranks on distinct cards (one rank a card,
    at most 4), peer access enabled, bitwise against its plain version on
    the CPU; the host-clock ms of a call with every card synchronised,
    beside the bytes that cross between cards.  With one card visible it
    prints that it did not run.  Returns its checks."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import psm_transfer as k7
    cards = torch.cuda.device_count()
    if cards < 2:
        log(f"{tag} (e) peer leg: 1 card visible, not run")
        return {}
    n = min(cards, 4)
    names = {torch.cuda.get_device_name(r) for r in range(n)}
    slabs, ids = _k7_case(gen, rng, n, ss=16)
    slabs = [s.to(f"cuda:{r}") for r, s in enumerate(slabs)]
    want = ops.psm_transfer([s.cpu() for s in slabs], ids, block_axis=1)
    n0 = k7.COUNTER.n
    got = ops.psm_transfer([s.clone() for s in slabs], ids, block_axis=1)
    for r in range(n):
        torch.cuda.synchronize(r)
    launches = k7.COUNTER.n - n0
    route = _route(k7.last_out.tolist())
    ok = all(_bitwise_equal(g.cpu(), w) for g, w in zip(got, want))
    live = ids[ids[:, :, 0] >= 0]
    remote = int((live[:, 2] % n != 0).sum())
    block_bytes = MESH_LAYERS * int(np.prod(MESH_PAGE)) * 2
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        ops.psm_transfer(slabs, ids, block_axis=1)
        for r in range(n):
            torch.cuda.synchronize(r)
        times.append((time.perf_counter() - t0) * 1e3)
    log(f"{tag} (e) peer leg: {n} cards ({', '.join(sorted(names))}), peer "
        f"access enabled, {len(live)} rows ({remote} to another card, "
        f"{remote * block_bytes} B over NVLink), {launches} launches (one a "
        f"source card; the last card's {route}), bitwise {ok}; host ms a "
        f"call, every card "
        f"synchronised (median of 5): {float(np.median(times)):.4f}")
    return {f"(e) peer leg over {n} cards bitwise": ok,
            "(e) one K7 launch a source card":
                launches == int((ids[:, :, 0] >= 0).any(1).sum())}


def phase_mesh(scrub, smi: str):
    """Phase 20: K7 and the sharded drain over a rank mesh on one card at
    llama3.2-3b's full pool width.  Returns K7's JSON row and the launch
    counts of the mesh path (the engines of (b)-(d) over ranks)."""
    import random
    import warnings
    from repro_torch.core import migration
    from repro_torch.core.cow_cache import PagedCoWCache
    from repro_torch.kernels import fused_dispatch as fd
    from repro_torch.kernels import ops
    from repro_torch.kernels import psm_transfer as k7
    from repro_torch.launch import mechanisms
    from repro_torch.launch.mesh import make_test_mesh
    tag = "[llama3.2-3b mesh]"
    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    rng = np.random.default_rng(SEED + 20)
    checks = {}
    block_bytes = MESH_LAYERS * int(np.prod(MESH_PAGE)) * 2
    lib, py = k7.library_constants(), k7.constants()
    checks["K7 constants equal the library's"] = lib == py
    log(f"{tag} card {smi}; block {block_bytes} B ({MESH_LAYERS} layers x "
        f"{MESH_PAGE} bf16); K7 constants {lib}")
    # (a) the library's plan against the Python statement
    # (the new legs draw from their own seeds: (a)-(e) keep their inputs)
    rng27 = np.random.default_rng(SEED + 27)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    same, counts, first_bad = _k7_plan_check(rng27, sms)
    checks[f"(a) K7's library plan equals plan_rows on {K7_PLAN_CALLS} "
           "calls"] = same == K7_PLAN_CALLS
    log(f"{tag} (a) K7 plan: {same} of {K7_PLAN_CALLS} random calls equal "
        f"to plan_rows ({counts}); first differing "
        f"{first_bad or 'none'}")
    # (a) K7 alone at n = 4 and 8 ranks
    row = None
    for n in (4, 8):
        slabs, ids = _k7_case(gen, rng, n)
        live = int((ids[:, :, 0] >= 0).sum())
        ok, launches, out, ms, (dev, seen), host_us = _k7_leg(
            slabs, ids, 1, scrub)
        checks[f"(a) K7 bitwise, n={n}, hops -{n - 1}..{n - 1}"] = ok
        checks[f"(a) K7 one launch, n={n}"] = launches == 1
        checks[f"(a) K7 bulk route, n={n}"] = out[5] == 1
        plain = time_ms(lambda: ops.psm_transfer(slabs, ids, block_axis=1,
                                                 use_kernel=False),
                        reps=5, scrub=scrub)
        library_ms = time_ms(_k7_library(slabs, ids), scrub=scrub)
        nbytes = cost.block_move_bytes(live, 1, block_bytes, 2)
        bound = nbytes / cost.HBM_BYTES_PER_S * 1e3
        log(f"{tag} (a) K7 n={n}: {live} rows over hops -{n - 1}..{n - 1} "
            f"({ids.shape[1] * n - live} skip rows), bitwise {ok}; "
            f"{_route(out)}; card {ms:.4f} ms, device {_fmt_ms(dev)} "
            f"({seen} of 10 launches in the trace), host {host_us:.1f} us "
            f"a call, bound {bound:.4f} ms ({nbytes} B, bytes), plain "
            f"{plain:.4f} ms, library {library_ms:.4f} ms "
            "(index_copy_(index_select) per rank pair)")
        if n == 8:
            row = dict(name="psm_transfer",
                       source="src/repro_torch/csrc/psm_transfer.cu",
                       replaces="src/repro/kernels/psm_transfer.py:74",
                       max_abs_err=0.0, ms=ms, device_ms=dev,
                       plain_ms=plain, bound_ms=bound, bound_by="bytes",
                       library_ms=library_ms)
            # the same call with rank 0's slab 8 bytes off: the word loop
            slabs[0] = _offset_copy(slabs[0], 8)
            ok, launches, out, ms, (dev, seen), host_us = _k7_leg(
                slabs, ids, 1, scrub)
            checks["(a) K7 word loop (a base 8 bytes off) bitwise in one "
                   "launch"] = ok and launches == 1 and out[5] == 0
            log(f"{tag} (a) K7 n=8, rank 0's base 8 bytes off: bitwise "
                f"{ok}; {_route(out)}; card {ms:.4f} ms, device "
                f"{_fmt_ms(dev)} ({seen} of 10), host {host_us:.1f} us, "
                f"bound {bound:.4f} ms")
        del slabs
        torch.cuda.empty_cache()
    # (a) more rows than the launch parameters carry: per-layer pages
    n, ss = 8, 96
    gen27 = torch.Generator(device="cuda").manual_seed(SEED + 27)
    slabs = [_bf16_pool((ss,) + MESH_PAGE, gen27) for _ in range(n)]
    ids = np.full((n, K7_WIDE_ROWS, 3), -1, np.int64)
    free = {r: list(rng27.permutation(np.arange(ss // 2, ss)))
            for r in range(n)}
    for my in range(n):
        for j in range(K7_WIDE_ROWS):
            tgt = (my + int(rng27.integers(-(n - 1), n)) + n) % n
            if free[tgt]:
                ids[my, j] = (rng27.integers(0, ss // 2), free[tgt].pop(),
                              tgt - my)
    live = int((ids[:, :, 0] >= 0).sum())
    ok, launches, out, ms, (dev, seen), host_us = _k7_leg(
        slabs, ids, 0, scrub)
    checks[f"(a) K7 above the launch parameters' room ({live} rows) "
           "bitwise in one launch"] = \
        ok and launches == 1 and out[7] == 1 and live > k7.ROW_CAPACITY
    page_bytes = int(np.prod(MESH_PAGE)) * 2
    bound = cost.block_move_bytes(live, 1, page_bytes, 2) / \
        cost.HBM_BYTES_PER_S * 1e3
    log(f"{tag} (a) K7 n=8, {live} rows of {page_bytes} B pages: bitwise "
        f"{ok}; {_route(out)}; card {ms:.4f} ms, device {_fmt_ms(dev)} "
        f"({seen} of 10), host {host_us:.1f} us, bound {bound:.4f} ms")
    del slabs
    torch.cuda.empty_cache()
    # (b) the sharded engine: fan-out, single-slab fused and mesh, bitwise
    mesh = make_test_mesh((1, 4), ("data", "model"), devices="cuda:0")
    pools = _mesh_pools(gen, MESH_NBLK, MESH_RING)
    paths = {"llama3.2-3b mesh": {}}

    def count(fn):
        """Run a main-path piece, adding its launches to the path."""
        c0 = _counts()
        out = fn()
        torch.cuda.synchronize()
        for k, v in _since(c0).items():
            paths["llama3.2-3b mesh"][k] = \
                paths["llama3.2-3b mesh"].get(k, 0) + v
        return out

    prng = random.Random(SEED + 20)
    progs = [_mesh_program(prng, MESH_NBLK, MESH_RING, MESH_INSTR)
             for _ in range(MESH_PROGRAMS)]
    for ring_rep in (False, True):
        what = "replicated ring" if ring_rep else "sharded ring"
        fan = _mesh_engine(pools, None, use_fused=False)
        one = _mesh_engine(pools, None)
        me = _mesh_engine(pools, mesh, ring_replicated=ring_rep)
        per_rank = [sum(me.slabs(n)[r].numel() * 2 for n in me.pools)
                    for r in range(mesh.size)]
        log(f"{tag} (b) {what}: {mesh.size} ranks on cuda:0, bytes a rank "
            f"{per_rank}, total {sum(per_rank)} B (K / V "
            f"{MESH_NBLK} blocks, ring {MESH_RING} slots)")
        events = []
        hook = lambda n_, p_, mech: events.append(mech)
        for prog in progs:
            mechanisms.drive(fan, prog)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mechanisms.drive(one, prog)
            torch.cuda.synchronize()
            t_one = (time.perf_counter() - t0) * 1e3
            fd.add_launch_hook(hook)
            try:
                c0 = _counts()
                f0 = me.queue.stats.flushes
                t0 = time.perf_counter()
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    count(lambda: mechanisms.drive(me, prog))
                t_mesh = (time.perf_counter() - t0) * 1e3
                ran = _since(c0)
                flushes = me.queue.stats.flushes - f0
            finally:
                fd.remove_launch_hook(hook)
            mesh_n = events.count("fused_mesh")
            legacy = len(events) - mesh_n
            events.clear()
            bad = _same_pools(me, one) + _same_pools(one, fan)
            checks[f"(b) {what}: bitwise three ways"] = \
                checks.get(f"(b) {what}: bitwise three ways", True) \
                and not bad
            if not ring_rep:
                checks["(b) one fused_mesh notify a flush"] = \
                    checks.get("(b) one fused_mesh notify a flush", True) \
                    and mesh_n == flushes and not legacy
            log(f"{tag} (b) {what}: {flushes} flushes, {mesh_n} fused_mesh "
                f"notifies, {legacy} fan-out calls (degraded flushes); K7 "
                f"{ran['psm_transfer']}, K1 {ran['fused_dispatch']} device "
                f"launches ({ran['psm_transfer'] / max(flushes, 1):.2f} / "
                f"{ran['fused_dispatch'] / max(flushes, 1):.2f} a flush); "
                f"program ms (host clock, synchronised): mesh {t_mesh:.3f}, "
                f"one device {t_one:.3f}; differing pools {bad or 'none'}")
        if not ring_rep:
            checks["(b) K7 and K1 ran on the mesh"] = \
                paths["llama3.2-3b mesh"].get("psm_transfer", 0) > 0 \
                and paths["llama3.2-3b mesh"].get("fused_dispatch", 0) > 0
        del fan, one, me
        torch.cuda.empty_cache()
    # (c) PSM migration over the mesh against one device
    twins = {}
    for key, m in (("mesh", mesh), ("one", None)):
        eng = _mesh_engine(pools, m)
        cache = PagedCoWCache(eng, MESH_PAGE[0], 32, 8)
        sids = [cache.new_sequence(prompt_len=MESH_PAGE[0] * b,
                                   prefer_slab=0) for b in (8, 12, 4, 16)]
        sids.append(cache.new_sequence(prompt_len=6 * MESH_PAGE[0],
                                       prefer_slab=1))
        for sid in sids:
            # prompt blocks hold data: no lazily zero source aliases away
            eng.alloc.mark_written(cache.blocks_of(sid))
        cache.fork(sids[2], 1)
        plan = migration.plan_rebalance(cache)
        if m is None:
            migration.execute(plan, cache, chunk_blocks=8)
        else:
            c0 = _counts()
            count(lambda: migration.execute(plan, cache, chunk_blocks=8))
            ran = _since(c0)
        twins[key] = (eng, plan)
    (me, mplan), (one, oplan) = twins["mesh"], twins["one"]
    bad = _same_pools(me, one)
    per = MESH_NBLK // mesh.size
    ranks = sum(1 for s, d in mplan.moves if s // per != d // per)
    checks["(c) migration: the plan and the pools bitwise"] = \
        mplan.moves == oplan.moves and not bad
    checks["(c) migration moved blocks across ranks through K7"] = \
        ranks > 0 and ran["psm_transfer"] > 0
    log(f"{tag} (c) migration: {len(mplan.moves)} moves ({ranks} across "
        f"ranks, {me.stats.psm_copies} PSM copies in {me.stats.launches} "
        f"sharded drains), K7 {ran['psm_transfer']} / K1 "
        f"{ran['fused_dispatch']} launches, pools bitwise {not bad}")
    del twins, me, one
    torch.cuda.empty_cache()
    # (d) snapshot and replay of a mesh engine
    small = _mesh_pools(gen, 64, 16)
    eng = _mesh_engine(small, mesh)
    prog = _mesh_program(prng, 64, 16, 8)
    count(lambda: mechanisms.drive(eng, prog[:4]))
    snap = eng.snapshot()
    count(lambda: mechanisms.drive(eng, prog[4:]))
    want = {n: p for n, p in eng.pools.items()}
    todo = len(eng.journal.since(snap.index))
    for n in list(eng.pools):
        eng.kill_pool(n)
    rep = count(lambda: eng.recover(snapshot=snap))
    bad = [n for n in want if not _bitwise_equal(eng.pools[n], want[n])]
    checks["(d) replay of a mesh engine bitwise"] = \
        not bad and rep.replayed_flushes == todo \
        and set(rep.pools_restored) == set(want)
    log(f"{tag} (d) snapshot at flush {snap.index}, {todo} flushes "
        f"replayed, pools restored {list(rep.pools_restored)}, differing "
        f"{bad or 'none'}")
    del eng, want, small, pools
    torch.cuda.empty_cache()
    checks.update(mesh_peer_leg(gen, rng, tag))
    log(f"{tag} phase 20 took {time.perf_counter() - t_phase:.1f} s")
    for name, ok in checks.items():
        log(f"{tag} {'ok  ' if ok else 'FAIL'} {name}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"mesh checks failed: {failed}")
    return row, paths


#: phase groups that ``--phases`` selects, with the phases each needs:
#: 7-8 run on phase 6's pools, 8's Fig. 2, 15, 17, 18 and 19 on phase 5's
#: weights
# ---------------------------------------------------------------------------
# phase 21: training (TrainConfig, the data pipeline, AdamW, the loss and the
# training forward, make_train_step / train_loop with checkpoints)
# ---------------------------------------------------------------------------

#: (a) llama3.2-3b at full width and depth: the batch, steps, the peak
#: memory above which the run drops to B = 1
TRAIN_ARCH, TRAIN_B, TRAIN_S, TRAIN_STEPS = "llama3.2-3b", 2, 1024, 8
TRAIN_PEAK_LIMIT = 75e9
#: (b) card against CPU: the reduced configs, steps, batch
TRAIN_XDEV_ARCHS, TRAIN_XDEV_STEPS, TRAIN_XDEV_B, TRAIN_XDEV_S = \
    ("llama3.2-3b", "yi-6b"), 3, 4, 64
#: (b) the losses are fp32 means of fp32 sums in another order (cuBLAS's
#: fp32 products against the CPU's; TF32 off): rtol 1e-4; grad_norm, the
#: norm of bf16 cotangents summed in another order (one bf16 ulp 2^-8):
#: rtol 1e-2; the weights after the steps: 99.9% within 1e-2 x lr + 1e-6,
#: every one within 2 lr a step (Adam moves a weight by about lr x sign(g):
#: a grad within its error of zero may step either way)
XDEV_LOSS_RTOL, XDEV_GNORM_RTOL = 1e-4, 1e-2
#: (c) the restart: the resumed losses against steps 10-19 of the run
#: without a failure, on the same card: rtol 1e-5 (the reference's; the
#: embedding's backward accumulates with sorted, not atomic, adds)
RESTART_RTOL = 1e-5
#: (c) microbatches 2 against 1: rtol 2e-2 (the reference's
#: tests/test_system.py: the fp32 sums of two halves in another order)
MICRO_RTOL = 2e-2

#: the profile's categories: ranges chip_smoke opens around the training
#: attention (the call and every KV-chunk body, recomputations included)
#: and the optimizer
TRAIN_RANGES = {"attention": "train.attention", "optimizer": "train.adamw"}


def _ranged(fn, label):
    from torch.profiler import record_function

    def call(*args, **kw):
        with record_function(label):
            return fn(*args, **kw)
    return call


class TrainRanges:
    """Open :data:`TRAIN_RANGES` ranges while in effect: around
    ``attention_train`` (transformer.py's reference), around each KV-chunk
    body that models/attention.py checkpoints (so that backward's
    recomputation is in the range), and around ``apply_updates``."""

    def __enter__(self):
        from repro_torch.launch import train
        from repro_torch.models import attention, transformer
        att, opt = TRAIN_RANGES["attention"], TRAIN_RANGES["optimizer"]
        ckpt = attention.checkpointed
        self.saved = [(transformer, "attention_train"),
                      (attention, "checkpointed"), (train, "apply_updates")]
        self.saved = [(m, n, getattr(m, n)) for m, n in self.saved]
        transformer.attention_train = _ranged(transformer.attention_train,
                                              att)
        attention.checkpointed = \
            lambda fn, *a, **k: ckpt(_ranged(fn, att), *a, **k)
        train.apply_updates = _ranged(train.apply_updates, opt)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def train_split(events) -> dict:
    """Split a profiled training step's device time (``events``:
    ``prof.events()``) by the CPU op that launched each kernel (the op's
    ``kernels``): the training attention (inside a ``train.attention``
    range, or the backward of an op that ran inside one, linked by its
    forward thread and sequence number), the optimizer (inside
    ``train.adamw``), the matrix products elsewhere (:data:`GEMM_KEYS`)
    and the rest (elementwise, reductions, copies).  A range's
    device-side span, linked to it under its own name, is not a kernel;
    a kernel linked to two events of one correlation id counts once
    (``repeats`` counts the drops).  Returns us per category."""
    att, opt = TRAIN_RANGES["attention"], TRAIN_RANGES["optimizer"]
    cuda = torch.autograd.DeviceType.CUDA

    def ancestors(e):
        while e is not None:
            yield e
            e = e.cpu_parent

    def in_range(e, label):
        return any(a.name == label for a in ancestors(e))

    ops = [e for e in events if e.device_type != cuda]
    fwd = {(e.thread, e.sequence_nr) for e in ops
           if e.sequence_nr >= 0 and "evaluate_function" not in e.name
           and in_range(e, att)}
    out = {"attention": 0.0, "optimizer": 0.0, "gemm": 0.0, "other": 0.0,
           "repeats": 0}
    seen = set()
    for e in ops:
        for k in e.kernels:
            if k.name == e.name:
                continue
            key = (e.id, k.name, k.duration)
            if key in seen:
                out["repeats"] += 1
                continue
            seen.add(key)
            if in_range(e, opt):
                cat = "optimizer"
            elif in_range(e, att) or any(
                    "evaluate_function" in a.name
                    and (a.fwd_thread, a.sequence_nr) in fwd
                    for a in ancestors(e)):
                cat = "attention"
            elif any(g in k.name for g in GEMM_KEYS):
                cat = "gemm"
            else:
                cat = "other"
            out[cat] += k.duration
    return out


def profile_train_step(step, smi: str, tag: str, step_ms: float,
                       split: bool = True) -> None:
    """One more training step under torch.profiler with
    :class:`TrainRanges`: wall and device busy ms, idle share (also
    against ``step_ms``, the unprofiled step: the profiler's own host
    work stretches the profiled one), the ten largest kernels, and the
    split (:func:`train_split`) into the training attention, the matrix
    products, the optimizer, the rest of the device time and the host
    gap.  ``split=False`` records the device only and reads its kernels
    from the exported trace, with no split (a placed mesh step's hundreds
    of thousands of CPU ops would take minutes to read)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    ranges_on = TrainRanges() if split else contextlib.nullcontext()
    if split:
        activities.insert(0, ProfilerActivity.CPU)
    with ranges_on, profile(activities=activities) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = {}
    if split:
        cuda = torch.autograd.DeviceType.CUDA
        events = prof.events()
        # device-side events, less the ranges' spans (ours and autograd's:
        # a span carries its CPU range's name)
        ranges = {e.name for e in events if e.device_type != cuda}
        for e in events:
            if e.device_type == cuda and e.name not in ranges \
                    and not getattr(e, "is_user_annotation", False):
                us, n = kernels.get(e.name, (0.0, 0))
                kernels[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    else:
        # the trace's kernel records, read from its JSON (building the
        # profiler's event objects takes tens of seconds a placed step)
        import os
        import tempfile
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        finally:
            os.remove(path)
        for e in trace.get("traceEvents", []):
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
                us, n = kernels.get(e["name"], (0.0, 0))
                kernels[e["name"]] = (us + float(e.get("dur", 0)), n + 1)
    rows = [(us, n, name) for name, (us, n) in kernels.items()]
    busy = sum(r[0] for r in rows)
    if not busy:
        log(f"{tag} profile: device time not measured (the profiler "
            "recorded no kernel)")
        return
    log(f"{tag} profile of one step: wall {wall_us / 1e3:.2f} ms, device "
        f"busy {busy / 1e3:.2f} ms, idle share {1 - busy / wall_us:.3f}; "
        f"against the unprofiled median step ({step_ms:.1f} ms) "
        f"{1 - busy / 1e3 / step_ms:.3f} ({smi})")
    for dev, count, key in sorted(rows, reverse=True)[:10]:
        log(f"{tag}   {dev / 1e3:8.3f} ms {count:6d} calls  {key[:90]}")
    if not split:
        return
    split = train_split(events)
    cats = ("attention", "gemm", "optimizer", "other")
    log(f"{tag} split: training attention {split['attention'] / 1e3:.2f} "
        f"ms, GEMMs {split['gemm'] / 1e3:.2f} ms, optimizer (AdamW, clip) "
        f"{split['optimizer'] / 1e3:.2f} ms, elementwise and other "
        f"{split['other'] / 1e3:.2f} ms (sum "
        f"{sum(split[c] for c in cats) / busy:.3f} of busy, "
        f"{split['repeats']} repeated kernel records dropped); host gap "
        f"{(wall_us - busy) / 1e3:.2f} ms under the profiler, "
        f"{step_ms - busy / 1e3:.2f} ms against the unprofiled step")


def _xdev_params_ok(card: dict, cpu: dict, lr_sum: float):
    """(ok, worst |diff|, share within the tight bound) of the weights
    after the card-against-CPU steps (see :data:`XDEV_LOSS_RTOL`)."""
    worst, n_tight, n = 0.0, 0, 0
    for name, t in card.items():
        d = (t.detach().cpu() - cpu[name].detach()).abs()
        worst = max(worst, float(d.max()))
        n_tight += int((d <= 1e-2 * lr_sum + 1e-6).sum())
        n += d.numel()
    share = n_tight / n
    return worst <= 2 * lr_sum + 1e-6 and share >= 0.999, worst, share


def phase_train(smi: str) -> dict:
    """Phase 21: training (see the module docstring).  Returns (a)'s run
    for phase 24: the batch, each step's loss and grad_norm, ms a step
    (median of steps 2-7) and the peak allocation."""
    import math
    import shutil
    import tempfile
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data import make_batch, to_device
    from repro_torch.launch.train import (make_train_step, train_loop,
                                          train_state)
    from repro_torch.optim import cosine_schedule
    from repro_torch.runtime import NodeFailure
    from repro_torch.weights import init_params
    tag = f"[{TRAIN_ARCH} training]"
    t_phase = time.perf_counter()
    c0 = _counts()
    checks = {}
    f32 = torch.float32

    # (a) full width and depth -----------------------------------------
    cfg = get_config(TRAIN_ARCH)
    # what train_loop builds for an 8-step run
    tcfg = TrainConfig(total_steps=TRAIN_STEPS,
                       warmup_steps=max(TRAIN_STEPS // 10, 1))
    n_par = cfg.param_count()
    gb = 1e9
    log(f"{tag} (a) reckoning: {n_par:,} parameters; fp32 masters, grads, "
        f"m and v 4 x {4 * n_par / gb:.2f} = {16 * n_par / gb:.1f} GB; bf16 "
        f"views {2 * n_par / gb:.1f} GB; one chunk of logits {TRAIN_B} x 512 "
        f"x {cfg.padded_vocab:,} x 4 B = "
        f"{TRAIN_B * 512 * cfg.padded_vocab * 4 / gb:.2f} GB; layer inputs "
        f"kept {cfg.num_layers} x {TRAIN_B} x {TRAIN_S} x {cfg.d_model} x 2 B"
        f" = {cfg.num_layers * TRAIN_B * TRAIN_S * cfg.d_model * 2 / gb:.2f}"
        " GB; predicted peak 62-68 GB")
    B = TRAIN_B
    for attempt in (0, 1):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()    # what earlier phases keep
        model = init_params(cfg, seed=SEED, device="cuda", param_dtype=f32)
        allocated = torch.cuda.memory_allocated() - held
        state = train_state(model)
        step = make_train_step(model, tcfg)
        batches = [to_device(make_batch(cfg, B, TRAIN_S, i), "cuda")
                   for i in range(TRAIN_STEPS)]
        metrics, times = [], []
        for i, batch in enumerate(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            metrics.append({k: float(v) for k, v in m.items()})
        peak = torch.cuda.max_memory_allocated()
        if peak <= TRAIN_PEAK_LIMIT or B == 1:
            break
        log(f"{tag} (a) peak {peak / gb:.2f} GB at B = {B} passes "
            f"{TRAIN_PEAK_LIMIT / gb:.0f} GB: B = 1")
        B = 1
        del model, state, step, batches
    losses = [m["loss"] for m in metrics]
    lrs = [m["lr"] for m in metrics]
    want_lr = [float(cosine_schedule(tcfg, float(i + 1)))
               for i in range(TRAIN_STEPS)]
    steady = sorted(times[2:])
    ms = 1e3 * steady[len(steady) // 2]
    tokens = B * TRAIN_S
    ln_v = math.log(cfg.padded_vocab)
    log(f"{tag} (a) {TRAIN_STEPS} steps at B = {B} x S = {TRAIN_S} "
        f"({tokens} tokens a step), remat {tcfg.remat_policy!r}: losses "
        + " ".join(f"{x:.4f}" for x in losses))
    log(f"{tag} (a) grad_norm " + " ".join(f"{m['grad_norm']:.3f}"
                                           for m in metrics)
        + "; lr " + " ".join(f"{x:.3e}" for x in lrs))
    log(f"{tag} (a) weights {allocated / gb:.2f} GB allocated for "
        f"{n_par:,} fp32 parameters; peak torch.cuda.max_memory_allocated "
        f"{peak / gb:.2f} GB, of which {held / gb:.2f} GB held by earlier "
        "phases; step ms "
        + " ".join(f"{1e3 * t:.1f}" for t in times)
        + f"; median of steps 2-7 {ms:.1f} ms, {tokens / ms * 1e3:.0f} "
        f"tokens/s ({smi})")
    checks.update({
        "(a) every loss and grad_norm finite":
            all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                for m in metrics),
        f"(a) step 0's loss within [ln V - 1, ln V + 2] = [{ln_v - 1:.2f}, "
        f"{ln_v + 2:.2f}]": ln_v - 1 <= losses[0] <= ln_v + 2,
        "(a) lr follows cosine_schedule":
            all(abs(a - b) <= 1e-6 * abs(b) for a, b in zip(lrs, want_lr)),
        f"(a) peak memory under 80 GB ({peak / gb:.2f} GB)": peak < 80e9,
        "(a) every parameter fp32 and its grads' state on the card":
            all(p.dtype == f32 and p.is_cuda for p in state.params.values()),
    })
    profile_train_step(lambda: step(state, batches[0]), smi, tag, ms)
    del model, state, step, batches
    torch.cuda.empty_cache()
    single = {"B": B, "losses": losses,
              "grad_norms": [m["grad_norm"] for m in metrics], "ms": ms,
              "peak": peak}

    # (b) card against CPU ---------------------------------------------
    for arch in TRAIN_XDEV_ARCHS:
        rcfg = get_config(arch).reduced()
        xcfg = TrainConfig(total_steps=8, warmup_steps=1)
        runs = {}
        for dev in ("cpu", "cuda"):
            model = init_params(rcfg, seed=SEED, device="cpu",
                                param_dtype=f32).to(dev)
            state = train_state(model)
            step = make_train_step(model, xcfg)
            out = []
            for i in range(TRAIN_XDEV_STEPS):
                state, m = step(state, to_device(
                    make_batch(rcfg, TRAIN_XDEV_B, TRAIN_XDEV_S, i), dev))
                out.append({k: float(v) for k, v in m.items()})
            runs[dev] = (out, state.params)
        (cpu_m, cpu_p), (card_m, card_p) = runs["cpu"], runs["cuda"]
        lr_sum = sum(m["lr"] for m in cpu_m)
        p_ok, worst, share = _xdev_params_ok(card_p, cpu_p, lr_sum)
        loss_ok = all(abs(a["loss"] - b["loss"]) <= XDEV_LOSS_RTOL *
                      abs(b["loss"]) for a, b in zip(card_m, cpu_m))
        gn_ok = all(abs(a["grad_norm"] - b["grad_norm"]) <= XDEV_GNORM_RTOL
                    * b["grad_norm"] for a, b in zip(card_m, cpu_m))
        log(f"{tag} (b) {arch} reduced, {TRAIN_XDEV_STEPS} steps card / "
            "CPU: losses " + " ".join(f"{a['loss']:.6f}/{b['loss']:.6f}"
                                      for a, b in zip(card_m, cpu_m))
            + "; grad_norm " + " ".join(
                f"{a['grad_norm']:.5f}/{b['grad_norm']:.5f}"
                for a, b in zip(card_m, cpu_m))
            + f"; weights: max |diff| {worst:.3e} (2 x sum lr "
            f"{2 * lr_sum:.3e}), {share:.5f} within 1e-2 x sum lr + 1e-6")
        checks[f"(b) {arch}: losses within rtol {XDEV_LOSS_RTOL}"] = loss_ok
        checks[f"(b) {arch}: grad_norm within rtol {XDEV_GNORM_RTOL}"] = \
            gn_ok
        checks[f"(b) {arch}: updated weights agree"] = p_ok
        del runs, model, state, step

    # (c) restart, microbatches, Mamba2 and moe on the card --------------
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        loop = dict(batch=2, seq_len=64, smoke=True, device="cuda",
                    log_every=100)
        t0 = time.perf_counter()
        _, ref_losses = train_loop(TRAIN_ARCH, steps=20, **loop)
        t_ref = time.perf_counter() - t0
        raised = False
        try:
            train_loop(TRAIN_ARCH, steps=20, ckpt_dir=tmp,
                       inject_failure_at=15, checkpoint_every=10, **loop)
        except NodeFailure:
            raised = True
        _, resumed = train_loop(TRAIN_ARCH, steps=20, ckpt_dir=tmp,
                                checkpoint_every=10, **loop)
        rel = max(abs(a - b) / abs(b) for a, b in zip(resumed,
                                                      ref_losses[10:]))
        log(f"{tag} (c) restart: 20 steps ({t_ref:.2f} s), failure at 15, "
            f"resumed from step 10: {len(resumed)} losses, max rel diff "
            f"{rel:.3e} against steps 10-19 (rtol {RESTART_RTOL})")
        checks["(c) NodeFailure at step 15, resumed from checkpoint 10"] = \
            raised and len(resumed) == 10
        checks[f"(c) resumed losses equal steps 10-19 (rtol "
               f"{RESTART_RTOL})"] = rel <= RESTART_RTOL
        _, l1 = train_loop("yi-6b", steps=8, microbatches=1,
                           **dict(loop, batch=4))
        _, l2 = train_loop("yi-6b", steps=8, microbatches=2,
                           **dict(loop, batch=4))
        rel_mb = max(abs(a - b) / abs(b) for a, b in zip(l2, l1))
        log(f"{tag} (c) yi-6b reduced microbatches 2 against 1, 8 steps: "
            f"max rel diff {rel_mb:.3e} (rtol {MICRO_RTOL})")
        checks[f"(c) microbatches 2 track 1 (rtol {MICRO_RTOL})"] = \
            rel_mb <= MICRO_RTOL
        for arch, seq in (("mamba2-780m", 128), ("zamba2-2.7b", 64),
                          ("deepseek-moe-16b", 64)):
            _, ls = train_loop(arch, steps=10, **dict(loop, seq_len=seq))
            log(f"{tag} (c) {arch} reduced, 10 steps: losses "
                + " ".join(f"{x:.4f}" for x in ls))
            checks[f"(c) {arch} losses finite"] = \
                all(math.isfinite(x) for x in ls)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launched = {n: c for n, c in _since(c0).items() if c}
    checks["no K1-K7 launch in training"] = not launched
    log(f"{tag} kernel launches in phase 21: {launched or 'none'}")
    log(f"{tag} phase 21 took {time.perf_counter() - t_phase:.1f} s")
    for name, ok in checks.items():
        log(f"{tag} {'ok  ' if ok else 'FAIL'} {name}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"training checks failed: {failed}")
    return single


# ---------------------------------------------------------------------------
# phase 24: training over a rank mesh (make_train_step(mesh=) under
# TrainConfig.sharding, build_train_step's shardings, every block of the
# loss on the rank that holds it, moe training through the placed paths,
# the elastic restore)
# ---------------------------------------------------------------------------

#: (a) / (b): phase 21 (a)'s weights and batches over 8 ranks of the card,
#: (a) all 8 of them, (b) the first MESH_TP_STEPS
MESH_TRAIN_SHAPE, MESH_TRAIN_AXES = (2, 4), ("data", "model")
MESH_TP_STEPS = 3
#: (a) / (b) limits against phase 21 (a)'s single-device run.  Step 0's
#: loss is the same function with every product run by the rows of a
#: batch block (the same products: rtol 1e-5, bitwise on an H100) and
#: the training attention by blocks (fp32 products of other shapes).
#: Under "tp" the products also split by output columns and by
#: contraction over the ranks, bf16 products of other shapes that round
#: to other bf16 values, and the reference's own jitted "tp" step
#: leaves its one-device step's loss by 1.9e-5 at step 0
#: (tests/test_torch_mesh_train.py::
#: test_placed_steps_leave_one_device_as_the_reference_does, reduced
#: llama3.2-3b in bf16 over (2, 4) CPU ranks; the port's 2.2e-5 there):
#: MESH_TP_LOSS0_RTOL.
#: Later losses: Adam moves a weight by about lr x sign(g) a step, and a
#: grad within its error of zero may step either way, so the weights
#: drift apart by up to 2 lr a step: rtol 1e-3.  grad_norm, the norm of
#: bf16 cotangents summed per block in another order: rtol 1e-3 at step
#: 0, 1e-2 later (phase 21 (b)'s)
MESH_LOSS0_RTOL, MESH_LOSS_RTOL, MESH_TP_LOSS0_RTOL = 1e-5, 1e-3, 5e-5
MESH_GNORM0_RTOL, MESH_GNORM_RTOL = 1e-3, 1e-2
#: (a) runs 8 steps.  Each of its two batch ranks sums one sequence's
#: weight grads, rounded to bf16 on that rank, into the fp32 masters,
#: where one device rounds the sum over both sequences once, and Adam
#: carries that difference on: the grad_norms of the random model (10.4
#: to 1.8 over the 8 steps) leave one device's by 1e-2 to 5e-2 at steps
#: 5-6 (an H100 at 700 W), as the reference's sharded step leaves its
#: one-device step (the test above).  One device's own step over the
#: same batches in MESH_TWIN_MICROBATCHES microbatches makes the same
#: per-sequence sums: every grad_norm of (a) is held within
#: MESH_GNORM_RTOL of phase 21 (a)'s, or within MESH_DRIFT_FACTOR times
#: the furthest that this twin strays from phase 21 (a)'s, and printed
#: beside the twin's
MESH_TWIN_MICROBATCHES, MESH_DRIFT_FACTOR = 2, 3.0
#: (c) deepseek-moe-16b at its published width, the depth cut to 2 layers
#: (4 fit beside 18 B a parameter: fp32 masters, grads, m, v, bf16 views;
#: 2 keep the script within its time); the batch (B divisible by 8 for
#: ("data",) 8, S by 8 for ("model",) 8)
MOE_TRAIN_LAYERS, MOE_TRAIN_B, MOE_TRAIN_S, MOE_TRAIN_STEPS = 2, 8, 512, 3
#: (c) one layer on 8 card ranks against 8 CPU ranks: the tokens; fp32
#: activations (the bf16 ones of the published config round the CPU's and
#: the card's products apart, and the router then ranks experts apart:
#: PR 31's chip run 1); the loss rtol 1e-4 (phase 21 (b)'s); each leaf's
#: grad within 2^-5 of the leaf's largest |grad| (the grads are bf16
#: cotangents of the bf16 views: a few bf16 ulps of 2^-8 summed in another
#: order; the CPU tests' 3%)
MOE_XDEV_B, MOE_XDEV_S = 2, 128
MOE_XDEV_LOSS_RTOL, MOE_XDEV_GRAD_SHARE = 1e-4, 2 ** -5
#: (d) the elastic run: llama3.2-3b reduced, B x S, steps, a checkpoint
#: every 5 steps, a failure at step 7; the resumed steps 5-9 on 4 ranks
#: (2 microbatches keep the batch) against the run without a failure:
#: rtol 1e-3 (two microbatches' fp32 sums in another order; the CPU test,
#: tests/test_torch_mesh_elastic.py, holds 1e-4)
ELASTIC_B, ELASTIC_S, ELASTIC_STEPS = 4, 64, 10
ELASTIC_EVERY, ELASTIC_FAIL, ELASTIC_RTOL = 5, 7, 1e-3
#: (e) a batch every rank of (2, 4) holds a block of under "fsdp" (the
#: batch over ("data", "model"): one sequence a rank, S = TRAIN_S) and
#: its steps, against one device's steps over the same batches (60.8 GB
#: reckoned by the walk; in 4 microbatches the fp32 accumulators take it
#: past the card's 80 GB): the limits of (a) / (b)
MESH_FULL_B, MESH_FULL_STEPS = 8, 3
#: seconds the legs' walks (a process each, 17-21 s on the card's host),
#: started once every leg is timed, may take
MESH_WALK_TIMEOUT = 240


def _within(a: float, b: float, rtol: float) -> bool:
    return abs(a - b) <= rtol * abs(b)


def _loss_without_mesh(model, params, batch, tcfg) -> float:
    """The loss of ``batch`` against bf16 views of ``params`` gathered on
    the card, without a mesh (every moe FFN on the local path), under
    ``no_grad``."""
    from repro_torch.launch.mesh import gather
    from repro_torch.launch.train import bf16_views
    with torch.no_grad():
        views = {n: gather(v, "cuda") for n, v in bf16_views(params).items()}
        _, met = torch.func.functional_call(
            model, views, (batch, tcfg.remat_policy))
    return float(met["loss"])


def _mesh_walk(cfg, tcfg, B: int, S: int, shape=MESH_TRAIN_SHAPE,
               axes=MESH_TRAIN_AXES):
    """The op-cost walk of one placed step of ``cfg`` at B x S under
    ``tcfg`` over ``meta`` ranks of ``shape``, all on one device as the
    card's ranks are (``Walk(one_device=True)``): its ``peak_all`` is the
    card's reckoned peak, its ``"gather"`` peer bytes a rank the blocks
    each rank took (weights' ZeRO-3 blocks, activation rows), its FLOPs
    the step's.  Returns (the walk, walk seconds)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.dryrun import build_cell
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.op_cost import Walk
    mesh = make_test_mesh(shape, axes, devices="meta")
    walk = Walk(mesh.size, one_device=True)
    t0 = time.perf_counter()
    with walk:
        fn, arguments = build_cell(cfg, ShapeConfig("train", S, B, "train"),
                                   mesh, tcfg)
        walk.run(fn, arguments)
    return walk, time.perf_counter() - t0


def _mesh_walks(out: str, sharding: str, b: int) -> None:
    """:func:`_mesh_walk` of one of phase 24's llama3.2-3b legs, for a
    process of its own: writes the walk's ``peak_all``, its ``"gather"``
    bytes a rank and seconds as JSON to ``out``."""
    from repro_torch.configs import TrainConfig, get_config
    walk, secs = _mesh_walk(get_config(TRAIN_ARCH), TrainConfig(
        total_steps=TRAIN_STEPS, warmup_steps=max(TRAIN_STEPS // 10, 1),
        sharding=sharding), b, TRAIN_S)
    with open(out, "w") as f:
        json.dump({"peak_all": walk.peak_all, "seconds": secs,
                   "gather": [p.get("gather", 0) for p in walk.rank_paths]},
                  f)


def _mesh_train_run(cfg, tcfg, mesh, batches, before=None) -> dict:
    """Seed-``SEED`` fp32 weights of ``cfg`` on the card, the state placed
    by ``build_train_step``'s ``shard_state`` over ``mesh`` (the model's
    own tensors released), one step a batch.  ``before(model, params)``
    runs first.  Returns the metrics, the step times, the peak allocation
    (reset before the weights) and the steps' own peak above what was
    held before the weights (reset after the state is placed), the
    parameter count, the bytes each rank holds, and the model, state and
    step."""
    from repro_torch.data import batch_logical_axes
    from repro_torch.launch.mesh import rank_bytes
    from repro_torch.launch.train import build_train_step, train_state
    from repro_torch.models import moe
    from repro_torch.weights import init_params, params_axes
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    model = init_params(cfg, seed=SEED, device="cuda",
                        param_dtype=torch.float32)
    n_par = sum(p.numel() for p in model.parameters())
    step, shard_state, _ = build_train_step(
        model, tcfg, mesh, params_axes(model), batch_logical_axes(cfg))
    state = train_state(model, shard_state(dict(model.named_parameters())))
    leaves = [x for tree in (state.params, state.opt.m, state.opt.v)
              for x in tree.values()]
    out = {"rank_bytes": rank_bytes(leaves, mesh), "held": held,
           "n_par": n_par}
    if before is not None:
        out["before"] = before(model, state.params)
    moe.PATH_COUNTS.clear()
    moe.RECOMPUTE_COUNTS.clear()
    peak_init = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    metrics, times = [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    step_peak = torch.cuda.max_memory_allocated()
    out.update(metrics=metrics, times=times,
               peak=max(peak_init, step_peak), step_peak=step_peak - held,
               paths=dict(moe.PATH_COUNTS),
               recomputed=dict(moe.RECOMPUTE_COUNTS))
    out.update(model=model, state=state, step=step)
    return out


def _single_run(cfg, base, batches) -> dict:
    """One device's steps over ``batches`` from seed-``SEED`` fp32
    weights under ``base``: phase 21 (a)'s keys (losses, grad_norms, ms:
    the slower of steps 1-2, peak) for :func:`_held_against_single`."""
    from repro_torch.launch.train import make_train_step, train_state
    from repro_torch.weights import init_params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = init_params(cfg, seed=SEED, device="cuda",
                        param_dtype=torch.float32)
    state = train_state(model)
    step = make_train_step(model, base)
    losses, gnorms, times = [], [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    peak = torch.cuda.max_memory_allocated()
    del model, state, step
    torch.cuda.empty_cache()
    return {"losses": losses, "grad_norms": gnorms,
            "ms": 1e3 * max(times[1:]), "peak": peak}


def _held_against_single(run: dict, single: dict, steps: int, tag: str,
                         what: str, smi: str, checks: dict,
                         loss0_rtol: float = MESH_LOSS0_RTOL,
                         twin: dict = None) -> None:
    """Print and check a mesh run of llama3.2-3b against one device's run
    of the same batches (phase 21 (a)'s, or :func:`_single_run`'s for
    (e)); with ``twin`` (one device's run of the same batches in
    microbatches) every grad_norm within :data:`MESH_GNORM_RTOL` or
    :data:`MESH_DRIFT_FACTOR` times the furthest the twin's strays."""
    gb = 1e9
    ms_ = run["metrics"]
    losses = [m["loss"] for m in ms_]
    gnorms = [m["grad_norm"] for m in ms_]
    # the median of steps 2-7; of a 3-step run, the slower of steps 1-2
    tail = sorted(run["times"][2:] if steps > 3 else run["times"][1:])
    ms = 1e3 * tail[len(tail) // 2]
    log(f"{tag} {what}: losses (mesh / one device) " + " ".join(
        f"{a:.6f}/{b:.6f}" for a, b in zip(losses, single["losses"])))
    log(f"{tag} {what}: grad_norm " + " ".join(
        f"{a:.5f}/{b:.5f}" for a, b in zip(gnorms, single["grad_norms"])))
    gnorm_rtol = MESH_GNORM_RTOL
    if twin is not None:
        def apart(xs):
            return [abs(a - b) / abs(b)
                    for a, b in zip(xs, single["grad_norms"])]
        stray = max(apart(twin["grad_norms"]))
        gnorm_rtol = max(MESH_GNORM_RTOL, MESH_DRIFT_FACTOR * stray)
        log(f"{tag} {what}: one device in {MESH_TWIN_MICROBATCHES} "
            "microbatches: losses " + " ".join(
                f"{x:.6f}" for x in twin["losses"]) + "; grad_norm "
            + " ".join(f"{x:.5f}" for x in twin["grad_norms"])
            + "; grad_norm apart from one device's (twin / mesh) "
            + " ".join(f"{a:.2e}/{b:.2e}" for a, b in zip(
                apart(twin["grad_norms"]), apart(gnorms)))
            + f"; the twin's furthest {stray:.3e}, the limit "
            f"{gnorm_rtol:.3e}; mesh against the twin "
            + " ".join(f"{abs(a - b) / abs(b):.2e}" for a, b in zip(
                gnorms, twin["grad_norms"])))
    log(f"{tag} {what}: step ms " + " ".join(
        f"{1e3 * t:.1f}" for t in run["times"])
        + f"; steady {ms:.1f} ms against one device's {single['ms']:.1f} "
        f"ms = {ms / single['ms']:.3f}x; peak max_memory_allocated "
        f"{run['peak'] / gb:.2f} GB (one device: {single['peak'] / gb:.2f} "
        f"GB; {run['held'] / gb:.2f} GB held before); per rank "
        + " ".join(f"{b / gb:.3f}" for b in run["rank_bytes"])
        + f" GB of masters and moments ({sum(run['rank_bytes']) / gb:.2f}"
        f" GB) ({smi})")
    walk = run.get("walk")
    if walk is not None:
        log(f"{tag} {what}: the steps' own peak {run['step_peak'] / gb:.3f}"
            f" GB above what was held, the walk's reckoning of one step on "
            f"one card {walk['peak_all'] / gb:.3f} GB (ratio "
            f"{run['step_peak'] / walk['peak_all']:.4f}; walked in "
            f"{walk['seconds']:.1f} s); gathered a step (walk, \"gather\": "
            "weights' ZeRO-3 blocks and activation rows) per rank "
            + " ".join(f"{g / gb:.3f}" for g in walk["gather"]) + " GB")
    checks[f"{what}: step 0's loss within rtol {loss0_rtol}"] = \
        _within(losses[0], single["losses"][0], loss0_rtol)
    checks[f"{what}: every loss within rtol {MESH_LOSS_RTOL}"] = all(
        _within(a, b, MESH_LOSS_RTOL)
        for a, b in zip(losses, single["losses"]))
    checks[f"{what}: step 0's grad_norm within rtol {MESH_GNORM0_RTOL}"] = \
        _within(gnorms[0], single["grad_norms"][0], MESH_GNORM0_RTOL)
    checks[f"{what}: every grad_norm within rtol {gnorm_rtol:.3e}"] = all(
        _within(a, b, gnorm_rtol)
        for a, b in zip(gnorms, single["grad_norms"]))
    checks[f"{what}: peak under 80 GB"] = run["peak"] < 80e9


def _moe_xdev_layer(tcfg, checks: dict, tag: str) -> None:
    """(c)'s last check: one deepseek-moe-16b layer at published width,
    its loss and grads over ``("model",)`` 8 card ranks against 8 CPU
    ranks from the same weights and batch: the routes of every route call
    (forward and recomputation) equal, the loss and each leaf's grads
    within :data:`MOE_XDEV_LOSS_RTOL` / :data:`MOE_XDEV_GRAD_SHARE`."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import batch_logical_axes, make_batch, to_device
    from repro_torch.launch.mesh import gather, make_test_mesh, place
    from repro_torch.launch.train import build_train_step, loss_and_grads
    from repro_torch.models import moe
    from repro_torch.weights import init_params, params_axes
    cfg = dataclasses.replace(get_config("deepseek-moe-16b"), num_layers=1,
                              dtype="float32")
    model = init_params(cfg, seed=SEED, device="cpu",
                        param_dtype=torch.float32)
    batch = to_device(make_batch(cfg, MOE_XDEV_B, MOE_XDEV_S, 0), "cpu")
    runs = {}
    for name, devs in (("card", "cuda"), ("cpu", "cpu")):
        mesh = make_test_mesh((8,), ("model",), devices=devs)
        _, shard_state, _ = build_train_step(
            model, tcfg, mesh, params_axes(model), batch_logical_axes(cfg))
        sh = shard_state(dict(model.named_parameters()))
        params = {n: place(p, sh.params[n])
                  for n, p in model.named_parameters()}
        routes = []

        def hook(idx):
            routes.append(idx.cpu())
            return idx

        moe.ROUTE_HOOK = hook
        try:
            total, met, grads = loss_and_grads(model, params, batch, tcfg,
                                               mesh)
        finally:
            moe.ROUTE_HOOK = None
        runs[name] = (float(met["loss"]), routes,
                      {n: gather(g, "cpu") for n, g in grads.items()})
        del params, grads
    (lc, rc, gc), (lx, rx, gx) = runs["card"], runs["cpu"]
    same_routes = len(rc) == len(rx) > 0 and all(
        torch.equal(a, b) for a, b in zip(rc, rx))
    worst = max(float((gc[n] - gx[n]).abs().max()) /
                max(float(gx[n].abs().max()), 1e-30) for n in gx)
    log(f"{tag} (c) one layer at published width (fp32 activations), ("
        f"\"model\",) 8: loss card {lc:.6f} / CPU {lx:.6f}; {len(rc)} "
        f"route calls, routes {'equal' if same_routes else 'DIFFER'}; "
        f"worst leaf's grad |diff| / its largest |grad| {worst:.3e} "
        f"(limit {MOE_XDEV_GRAD_SHARE:.3e})")
    checks["(c) one layer: routes equal on card and CPU ranks"] = \
        same_routes
    checks[f"(c) one layer: loss within rtol {MOE_XDEV_LOSS_RTOL}"] = \
        _within(lc, lx, MOE_XDEV_LOSS_RTOL)
    checks["(c) one layer: grads within the bf16 limit"] = \
        worst <= MOE_XDEV_GRAD_SHARE


def phase_mesh_train(smi: str, single: dict) -> None:
    """Phase 24: training over ranks of the card (see the module
    docstring); ``single`` is phase 21 (a)'s run."""
    import dataclasses
    import os
    import tempfile
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data import make_batch, to_device
    from repro_torch.launch.mesh import make_test_mesh
    tag = "[mesh training]"
    t_phase = time.perf_counter()
    c0 = _counts()
    checks = {}
    gb = 1e9
    mesh = make_test_mesh(MESH_TRAIN_SHAPE, MESH_TRAIN_AXES, devices="cuda")

    # (a) / (b) llama3.2-3b at full width and depth -----------------------
    cfg = get_config(TRAIN_ARCH)
    B = single["B"]
    batches = [to_device(make_batch(cfg, B, TRAIN_S, i), "cuda")
               for i in range(TRAIN_STEPS)]
    fbatches = [to_device(make_batch(cfg, MESH_FULL_B, TRAIN_S, i), "cuda")
                for i in range(MESH_FULL_STEPS)]
    base = TrainConfig(total_steps=TRAIN_STEPS,
                       warmup_steps=max(TRAIN_STEPS // 10, 1))
    legs = [("(a) fsdp", "fsdp", B, batches),
            ("(b) tp", "tp", B, batches[:MESH_TP_STEPS]),
            (f"(e) fsdp B = {MESH_FULL_B}", "fsdp", MESH_FULL_B, fbatches)]
    # (e) every rank holds a batch block: one device steps the same batches
    # first
    refs = [single, single, _single_run(cfg, base, fbatches)]
    runs = []
    for (what, sharding, b, leg_batches), ref in zip(legs, refs):
        t_leg = time.perf_counter()
        tcfg = dataclasses.replace(base, sharding=sharding)
        steps = len(leg_batches)
        run = _mesh_train_run(cfg, tcfg, mesh, leg_batches)
        checks[f"{what}: masters and moments stored once "
               f"({12 * run['n_par'] / gb:.2f} GB)"] = \
            sum(run["rank_bytes"]) == 12 * run["n_par"]
        checks[f"{what}: the model's own parameters released"] = all(
            p.numel() == 0 for p in run["model"].parameters())
        tail = sorted(run["times"][2:] if steps > 3 else run["times"][1:])
        t_prof = time.perf_counter()
        profile_train_step(
            lambda: run["step"](run["state"], leg_batches[0]), smi,
            f"{tag} {what}", 1e3 * tail[len(tail) // 2], split=False)
        t_prof = time.perf_counter() - t_prof
        del run["model"], run["state"], run["step"]
        torch.cuda.empty_cache()
        log(f"{tag} {what} took {time.perf_counter() - t_leg:.1f} s "
            f"(the profiled step and its reading {t_prof:.1f} s)")
        runs.append((run, ref, steps, what, sharding))
    # every leg is timed: each leg's walk in a process of its own, beside
    # what follows, whose times are not compared (one device's twin of (a)
    # in microbatches, (c), (d)); read after (d)
    walk_outs, walkers = [], []
    for _, sharding, b, _ in legs:
        out = tempfile.NamedTemporaryFile(suffix=".json", delete=False)
        out.close()
        walk_outs.append(out.name)
        walkers.append(subprocess.Popen(
            [sys.executable, "-c", "import sys; sys.path.insert(0, "
             "sys.argv[1]); import chip_smoke; chip_smoke._mesh_walks("
             "sys.argv[2], sys.argv[3], int(sys.argv[4]))", str(ROOT),
             out.name, sharding, str(b)],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE))
    try:
        _mesh_train_rest(cfg, base, mesh, batches, runs, walkers,
                         walk_outs, smi, tag, checks)
    finally:
        for w in walkers:
            if w.poll() is None:
                w.kill()
            w.wait()
            w.stderr.close()
        for out in walk_outs:
            os.unlink(out)
    launched = {n: c for n, c in _since(c0).items() if c}
    checks["no K1-K7 launch in mesh training"] = not launched
    log(f"{tag} kernel launches in phase 24: {launched or 'none'}")
    log(f"{tag} phase 24 took {time.perf_counter() - t_phase:.1f} s")
    for name, ok in checks.items():
        log(f"{tag} {'ok  ' if ok else 'FAIL'} {name}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"mesh training checks failed: {failed}")


def _mesh_train_rest(cfg, base, mesh, batches, runs, walkers, walk_outs,
                     smi: str, tag: str, checks: dict) -> None:
    """Phase 24 after (a), (b) and (e) are timed, beside their walks
    (``walkers``, writing ``walk_outs``): one device's twin of (a), (c)
    and (d), whose times are not compared; then the walks read and every
    leg held against one device."""
    import dataclasses
    import math
    import shutil
    import tempfile
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data import batch_logical_axes, make_batch, to_device
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.train import (build_train_step, train_loop,
                                          train_state)
    from repro_torch.runtime import (NodeFailure, build_mesh,
                                     elastic_restore, plan_remesh)
    from repro_torch.weights import init_params, params_axes
    gb = 1e9
    t_leg = time.perf_counter()
    twin = _single_run(cfg, dataclasses.replace(
        base, microbatches=MESH_TWIN_MICROBATCHES), batches)
    del batches
    torch.cuda.empty_cache()
    log(f"{tag} one device's twin of (a) took "
        f"{time.perf_counter() - t_leg:.1f} s")

    # (c) deepseek-moe-16b at published width, depth cut -------------------
    t_leg = time.perf_counter()
    mcfg = dataclasses.replace(get_config("deepseek-moe-16b"),
                               num_layers=MOE_TRAIN_LAYERS)
    n_par = mcfg.param_count()
    full = get_config("deepseek-moe-16b")
    log(f"{tag} (c) deepseek-moe-16b cut to {MOE_TRAIN_LAYERS} of "
        f"{full.num_layers} layers (width, 64 experts top 6 kept): "
        f"{n_par:,} parameters x 18 B (fp32 masters, grads, m, v, bf16 "
        f"views) = {18 * n_par / gb:.1f} GB; the whole depth would need "
        f"{18 * full.param_count() / gb:.0f} GB")
    ln_v = math.log(mcfg.padded_vocab)
    mbatches = [to_device(make_batch(mcfg, MOE_TRAIN_B, MOE_TRAIN_S, i),
                          "cuda") for i in range(MOE_TRAIN_STEPS)]
    for what, shape, axes, sharding, want in (
            ("(c) model 8 tp", (8,), ("model",), "tp", "a2a"),
            ("(c) data 8 fsdp", (8,), ("data",), "fsdp", "fsdp")):
        tcfg = dataclasses.replace(base, sharding=sharding)
        mmesh = make_test_mesh(shape, axes, devices="cuda")
        run = _mesh_train_run(
            mcfg, tcfg, mmesh, mbatches,
            before=lambda model, params, _t=tcfg: _loss_without_mesh(
                model, params, mbatches[0], _t))
        losses = [m["loss"] for m in run["metrics"]]
        tail = sorted(run["times"][1:])
        log(f"{tag} {what}: B = {MOE_TRAIN_B} x S = {MOE_TRAIN_S}, "
            f"losses " + " ".join(f"{x:.4f}" for x in losses)
            + f" (step 0 without a mesh, no_grad: {run['before']:.4f}); "
            f"aux " + " ".join(f"{m['aux']:.4f}" for m in run["metrics"])
            + f"; forward paths {run['paths']}, recomputed "
            f"{run['recomputed']}; step ms (beside the walks) " + " ".join(
                f"{1e3 * t:.1f}" for t in run["times"])
            + f" (the slower of steps 1-2 {1e3 * tail[len(tail) // 2]:.1f}); "
            f"peak {run['peak'] / gb:.2f} GB; per rank " + " ".join(
                f"{b / gb:.2f}" for b in run["rank_bytes"]) + f" GB ({smi})")
        layers = MOE_TRAIN_LAYERS * MOE_TRAIN_STEPS
        checks[f"{what}: every FFN on the {want} path "
               f"({layers} forward calls)"] = \
            run["paths"] == {want: layers} == run["recomputed"]
        checks[f"{what}: losses finite"] = all(
            math.isfinite(x) for x in losses)
        checks[f"{what}: step 0's loss within [ln V - 1, ln V + 2]"] = \
            ln_v - 1 <= losses[0] <= ln_v + 2
        del run
        torch.cuda.empty_cache()
    del mbatches
    torch.cuda.empty_cache()
    _moe_xdev_layer(dataclasses.replace(base, sharding="tp"), checks, tag)
    torch.cuda.empty_cache()
    log(f"{tag} (c) took {time.perf_counter() - t_leg:.1f} s")
    t_leg = time.perf_counter()

    # (d) elastic: a failure over 8 ranks, resumed on 4 ----------------------
    tmp = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    try:
        loop = dict(steps=ELASTIC_STEPS, batch=ELASTIC_B, seq_len=ELASTIC_S,
                    smoke=True, log_every=100, mesh=mesh, async_save=False)
        _, ref = train_loop(TRAIN_ARCH, **loop)
        raised = False
        try:
            train_loop(TRAIN_ARCH, ckpt_dir=tmp,
                       checkpoint_every=ELASTIC_EVERY,
                       inject_failure_at=ELASTIC_FAIL, **loop)
        except NodeFailure:
            raised = True
        decision = plan_remesh(4, model_parallel=mesh.axis_size("model"),
                               global_batch=ELASTIC_B,
                               old_dp=mesh.axis_size("data"))
        mesh4 = build_mesh(decision, "cuda")
        rcfg = get_config(TRAIN_ARCH).reduced()
        tcfg = TrainConfig(total_steps=ELASTIC_STEPS,
                           warmup_steps=max(ELASTIC_STEPS // 10, 1),
                           microbatches=decision.microbatches)
        model = init_params(rcfg, seed=SEED + 1, device="cuda",
                            param_dtype=torch.float32)
        step, shard_state, _ = build_train_step(
            model, tcfg, mesh4, params_axes(model), batch_logical_axes(rcfg))
        example = train_state(model)
        state, start = elastic_restore(
            CheckpointManager(tmp), example, mesh4,
            lambda m: shard_state(example.params))
        resumed = []
        for i in range(start, ELASTIC_STEPS):
            state, m = step(state, to_device(
                make_batch(rcfg, ELASTIC_B, ELASTIC_S, i), "cuda"))
            resumed.append(float(m["loss"]))
        rel = max(abs(a - b) / abs(b) for a, b in zip(resumed, ref[start:]))
        log(f"{tag} (d) elastic: {ELASTIC_STEPS} steps over "
            f"{MESH_TRAIN_SHAPE}, failure at {ELASTIC_FAIL}, plan_remesh "
            f"to {decision.mesh_shape} ({decision.microbatches} "
            f"microbatches), restored step {start}: losses "
            + " ".join(f"{a:.6f}/{b:.6f}" for a, b in
                       zip(resumed, ref[start:]))
            + f"; max rel diff {rel:.3e} (rtol {ELASTIC_RTOL})")
        checks[f"(d) NodeFailure at step {ELASTIC_FAIL}, restored from "
               f"checkpoint {ELASTIC_EVERY} onto 4 ranks"] = \
            raised and start == ELASTIC_EVERY and \
            decision.mesh_shape == (1, 4)
        checks[f"(d) resumed losses within rtol {ELASTIC_RTOL}"] = \
            rel <= ELASTIC_RTOL
        del model, state, step, example
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"{tag} (d) took {time.perf_counter() - t_leg:.1f} s")
    t_leg = time.perf_counter()
    walks = []
    for w, out in zip(walkers, walk_outs):
        err = w.communicate(timeout=MESH_WALK_TIMEOUT)[1]
        if w.returncode != 0:
            raise RuntimeError(f"a leg's walk failed: {err[-2000:]!r}")
        with open(out) as f:
            walks.append(json.load(f))
    log(f"{tag} the walks of (a), (b) and (e) ended "
        f"{time.perf_counter() - t_leg:.1f} s after (d)")
    for (run, ref, steps, what, sharding), walk in zip(runs, walks):
        run["walk"] = walk
        _held_against_single(run, ref, steps, tag, what, smi, checks,
                             MESH_TP_LOSS0_RTOL if sharding == "tp"
                             else MESH_LOSS0_RTOL,
                             twin if what == "(a) fsdp" else None)


# ---------------------------------------------------------------------------
# phase 22: sharded serving over a rank mesh (ServingEngine(mesh=),
# PagedCoWCache(batch_groups=), the mesh branch of paged_attend_append)
# ---------------------------------------------------------------------------

#: phase 22's mesh: 8 ranks on the card, the batch in 2 groups of 4
MESH_SERVE_SHAPE, MESH_SERVE_AXES = (2, 4), ("data", "model")
#: (b) the prompts are phase 5's cut to this many tokens (two blocks)
CROSS_PROMPT = 120
#: (c) the replicated ring: 3 slots (8 shards do not divide it), prompts
#: of at most 3 pages, rounds
REPL_RING, REPL_PROMPT, REPL_ROUNDS = 3, 150, 3


class _GreedyWatch:
    """A ``sample_fn`` that feeds an engine the tokens of another run (the
    single-device engine's, in the live sequences' order) and records its
    own greedy choice and the logits it chose from, so the two engines
    stay on one script and every step is comparable."""

    def __init__(self):
        self.feed, self.own = iter(()), []

    def round(self, toks: dict):
        self.feed = iter([toks[s] for s in sorted(toks)])
        self.own.append([])

    def __call__(self, logits):
        self.own[-1].append((int(np.argmax(logits)), logits))
        return next(self.feed)


def _compare_greedy(ref_logits, ref_toks, watch, tag: str) -> tuple:
    """Each step's greedy choice of the mesh engine against the
    single-device engine's token (``ref_logits``: the logits each round's
    tokens were chosen from).  A step differs only where the single
    engine's top-1 / top-2 margin is within twice the largest |logit|
    difference of the two engines on that step (the only steps where the
    two can rank the top pair differently); such steps are logged with
    their position.  Returns (steps, near-tie steps, unexcused steps, max
    |logit diff|, limit of it)."""
    steps = ties = bad = 0
    worst, limit = 0.0, 0.0
    for rnd, (lg_ref, toks) in enumerate(zip(ref_logits, ref_toks)):
        for (own, lg), sid in zip(watch.own[rnd], sorted(toks)):
            ref = lg_ref[sid]
            diff = float(np.abs(lg - ref).max())
            worst = max(worst, diff)
            limit = max(limit, SERVE_RTOL * float(np.abs(ref).max()))
            steps += 1
            if own == toks[sid]:
                continue
            margin = _top2(ref)
            if margin <= 2 * diff:
                ties += 1
                log(f"{tag} near-tie at round {rnd + 1}, sequence {sid}: "
                    f"mesh {own} vs single {toks[sid]}, margin {margin:.3e}"
                    f" <= 2 x |logit diff| {diff:.3e}")
            else:
                bad += 1
                log(f"{tag} DIFFERS at round {rnd + 1}, sequence {sid}: "
                    f"mesh {own} vs single {toks[sid]}, margin {margin:.3e}"
                    f" > 2 x |logit diff| {diff:.3e}")
    return steps, ties, bad, worst, limit


def _global_mask(cache) -> np.ndarray:
    """The share mask of a batch-group cache in GLOBAL columns (slot), the
    layout one sweep over the whole pool reads."""
    mask = np.zeros((cache.alloc.num_blocks, cache.max_seqs), np.int8)
    for sid, seq in cache.seqs.items():
        mask[seq.blocks, cache.slot_of(sid)] = 1
    return mask


def _profile_mesh_round(step, tag: str, label: str = "(d)") -> dict:
    """One profiled round of the mesh engine: wall and device busy ms, the
    idle share, and the device ms of K2, K1, K7 and the LSE combine (the
    kernels launched inside ``lse_combine``, run in a profiler range);
    ``label`` leads its log lines."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import paged
    saved = paged.lse_combine

    def ranged(*args, **kw):
        with record_function("mesh.lse_combine"):
            return saved(*args, **kw)

    paged.lse_combine = ranged
    try:
        torch.cuda.synchronize()
        opening = torch.zeros(1, device="cuda")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # the trace can drop its window's first kernel (ROADMAP §3):
            # open the window with a one-element write
            opening.add_(1)
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        paged.lse_combine = saved
    cuda = torch.autograd.DeviceType.CUDA
    avgs = prof.key_averages()
    # a range's device-side span carries its CPU range's name (the
    # engine's "flush" / "drain" spans): not a kernel
    ranges = {a.key for a in avgs if a.device_type != cuda}
    rows, combine = [], 0.0
    for avg in avgs:
        if avg.key == "mesh.lse_combine":
            if avg.device_type != cuda:
                combine += getattr(avg, "device_time_total", 0.0)
            continue
        if avg.device_type != cuda or avg.key in ranges:
            continue
        dev = getattr(avg, "self_device_time_total", 0.0)
        if dev > 0:
            rows.append((dev, avg.count, avg.key))
    busy = sum(r[0] for r in rows)
    if not busy:
        log(f"{tag} {label} device time: not measured (the profiler "
            "recorded no kernel)")
        return {}

    def of(key):
        return sum(r[0] for r in rows if key in r[2]) / 1e3

    out = {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
           "idle": 1 - busy / wall_us, "K2_ms": of("paged_attn"),
           "K1_ms": of("drain_kernel"), "K7_ms": of("psm_kernel"),
           "combine_ms": combine / 1e3}
    out["other_ms"] = out["busy_ms"] - out["K2_ms"] - out["K1_ms"] \
        - out["K7_ms"] - out["combine_ms"]
    log(f"{tag} {label} one profiled round: wall {out['wall_ms']:.2f} ms, "
        f"device busy {out['busy_ms']:.2f} ms, idle share "
        f"{out['idle']:.3f}; K2 {out['K2_ms']:.3f} ms "
        f"({sum(r[1] for r in rows if 'paged_attn' in r[2])} launches), "
        f"K1 {out['K1_ms']:.3f} ms, K7 {out['K7_ms']:.3f} ms, LSE combine "
        f"{out['combine_ms']:.3f} ms (kernels in its range), other device "
        f"{out['other_ms']:.3f} ms, host gap "
        f"{out['wall_ms'] - out['busy_ms']:.2f} ms")
    for dev, count, key in sorted(rows, reverse=True)[:8]:
        log(f"{tag} {label}   {dev / 1e3:8.3f} ms {count:5d} calls  "
            f"{key[:90]}")
    return out


def phase_mesh_serve(params, smi: str) -> dict:
    """Phase 22: ``ServingEngine(mesh=)`` over 8 ranks of the card,
    llama3.2-3b at full width and depth on phase 5's weights.  Returns the
    launch counts of the path (the counted run of (a) and the fork round
    of (b))."""
    from repro_torch.kernels import fused_dispatch as fd
    from repro_torch.kernels import ref as kref
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.serve import ServingEngine
    from repro_torch.models import paged
    tag = "[llama3.2-3b mesh serve]"
    t_phase = time.perf_counter()
    cfg = params.cfg
    L = cfg.num_layers
    mesh = make_test_mesh(MESH_SERVE_SHAPE, MESH_SERVE_AXES, devices="cuda")
    n = mesh.size
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(2, cfg.vocab_size, size=k).astype(np.int32)
               for k in PROMPT_LENS]
    checks, path = {}, {}
    events = []
    hook = lambda n_, p_, mech: events.append(mech)

    def engine(m, **kw):
        return ServingEngine(cfg, params, max_seqs=MAX_SEQS,
                             max_blocks_per_seq=MAX_BLOCKS_PER_SEQ, mesh=m,
                             **kw)

    # (a) phase 5's protocol, the single-device engine first
    one = engine(None)
    sids = _admit_all(one, prompts)
    ref_toks, ref_logits, one_ms = [], [], []
    for rnd in range(ROUNDS):
        if rnd == 1:
            one.fork(sids[0], 2)
        # the logits each round's tokens come from
        ref_logits.append({s: lg.copy() for s, lg in one.last_logits.items()})
        t = time.perf_counter()
        ref_toks.append(one.decode_round())
        torch.cuda.synchronize()
        one_ms.append((time.perf_counter() - t) * 1e3)
    del one
    torch.cuda.empty_cache()
    eng = engine(mesh)
    cache = eng.cache
    ss = eng.engine.num_blocks // n
    log(f"{tag} card {smi}; {n} ranks on cuda:0 ({MESH_SERVE_SHAPE} over "
        f"{MESH_SERVE_AXES}); {eng.engine.num_blocks} blocks a pool, slabs "
        f"of {ss}, {eng.engine._pool_block_bytes('k')} B a block; "
        f"batch_groups {cache.batch_groups}, mask columns "
        f"{cache.device_tables()[1].shape[1]}; ring {eng.engine.stage_capacity}"
        f" slots, hint {eng.engine.group['k_stage'].sharding}")
    checks["(a) batch_groups == 2, 4 local mask columns, slabs of 64"] = \
        cache.batch_groups == 2 and \
        cache.device_tables()[1].shape[1] == MAX_SEQS // 2 and ss == 64
    watch = _GreedyWatch()
    c_path = _counts()
    k3_per, mesh_ms, per_round = [], [], []
    fd.add_launch_hook(hook)
    try:
        msids = []
        for p in prompts:
            c0 = _counts()
            msids.append(eng.add_request(p))
            k3_per.append(_since(c0)["flash_attention"])
        for rnd in range(ROUNDS):
            if rnd == 1:
                eng.fork(msids[0], 2)
            watch.round(ref_toks[rnd])
            e0, c0 = len(events), _counts()
            t = time.perf_counter()
            eng.decode_round(sample_fn=watch)
            torch.cuda.synchronize()
            mesh_ms.append((time.perf_counter() - t) * 1e3)
            ran = _since(c0)
            per_round.append((events[e0:], ran["fused_dispatch"],
                              ran["psm_transfer"], ran["paged_attention"]))
    finally:
        fd.remove_launch_hook(hook)
    for k, v in _since(c_path).items():
        path[k] = path.get(k, 0) + v
    checks["(a) the same sequence ids"] = msids == sids
    steps, ties, bad, worst, limit = _compare_greedy(ref_logits, ref_toks,
                                                     watch, tag)
    checks["(a) greedy tokens equal the single-device engine's (or differ "
           "at logged near-ties)"] = bad == 0
    checks["(a) logits within SERVE_RTOL x max |logit| of the single-device "
           "engine's"] = worst <= limit
    checks["(a) at most one fused_mesh drain a round"] = all(
        ev in ([], ["fused_mesh"]) for ev, *_ in per_round)
    checks[f"(a) K2 == {L} x {n} a round"] = all(
        k2 == L * n for *_, k2 in per_round)
    checks[f"(a) K3 == {L} per admission"] = all(k == L for k in k3_per)
    checks["(a) every block of a sequence lies in its group"] = all(
        cache.group_of_block(b) == seq.group
        for seq in cache.seqs.values() for b in seq.blocks)
    checks["(a) K7 and K1 ran on the path"] = \
        path.get("psm_transfer", 0) > 0 and path.get("fused_dispatch", 0) > 0
    steady = lambda xs: float(np.median(xs[2:]))
    log(f"{tag} (a) admitted {PROMPT_LENS}, forked, {ROUNDS} rounds: "
        f"{steps} greedy steps, {ties} near-ties, {bad} unexcused; max "
        f"|logit diff| vs single {worst:.3e} (limit {limit:.3e}); K1 / K7 "
        f"/ K2 a round {[(k1, k7, k2) for _, k1, k7, k2 in per_round]}; "
        f"fused_mesh a round {[len(ev) for ev, *_ in per_round]}; K3 per "
        f"admission {k3_per}; groups "
        f"{sorted((s, q.group) for s, q in cache.seqs.items())}")
    log(f"{tag} (d) ms a round (rounds 3-{ROUNDS}, median, host clock, "
        f"synchronised), {smi}: mesh {steady(mesh_ms):.2f} ms, single "
        f"device {steady(one_ms):.2f} ms ({steady(mesh_ms) / steady(one_ms):.2f}x)")
    # the combined attention of one layer against one sweep of the whole
    # pool (the plain version), on the engine's live tables
    li = L // 2
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    q = torch.randn((MAX_SEQS, cfg.num_heads, cfg.head_dim), generator=gen,
                    device="cuda").to(torch.bfloat16)
    table, mask, base = cache.device_tables()
    lens = torch.as_tensor(cache.seq_lens(), device="cuda")
    none = torch.zeros(0, dtype=torch.long, device="cuda")
    ks = [s[li] for s in eng.engine.slabs("k")]
    vs = [s[li] for s in eng.engine.slabs("v")]
    kvh, hd = cfg.num_kv_heads, cfg.head_dim
    empty_kv = torch.zeros((MAX_SEQS, kvh, hd), dtype=torch.bfloat16,
                           device="cuda")
    combined, saved = [], paged.lse_combine

    def keep(*args, **kw):
        combined.append(saved(*args, **kw))
        return combined[-1]

    # the fp32 combine of each group, kept before the output's bf16 cast
    paged.lse_combine = keep
    c0 = _counts()
    try:
        got = paged.paged_attend_append(
            mesh, q, empty_kv, empty_kv, ks, vs, [(none, none, none)] * n,
            mask, base, lens, page=eng.rc.page_size)
    finally:
        paged.lse_combine = saved
    checked = _since(c0)
    fp32 = torch.cat(combined)
    whole_k, whole_v = torch.cat(ks), torch.cat(vs)
    gmask = torch.as_tensor(_global_mask(cache), device="cuda")
    acc, l, _ = kref.paged_attention_slab(q, whole_k, whole_v, gmask, base,
                                          lens, page=eng.rc.page_size)
    want = acc / l.clamp_min(1e-30)[..., None]
    err = float((fp32 - want).abs().max())
    checks["(a) one layer's combined attention equals one sweep of the "
           "gathered pool (plain version)"] = \
        err <= K2_ATOL and checked["paged_attention"] == n and \
        len(combined) == cache.batch_groups and \
        torch.equal(got, fp32.to(got.dtype))
    log(f"{tag} (a) layer {li}: {n} K2 partials LSE-combined in "
        f"{len(combined)} groups vs the plain version over the whole pool "
        f"with global columns, fp32 before the output's bf16 cast: max "
        f"|diff| {err:.3e} (limit K2_ATOL {K2_ATOL})")
    prof = _profile_mesh_round(eng.decode_round, tag)
    checks["(d) the profile saw K2"] = prof.get("K2_ms", 0) > 0
    del eng, cache, whole_k, whole_v, ks, vs
    torch.cuda.empty_cache()

    # every K2 / K3 call of the admissions and the first round against its
    # plain version on the same inputs (a check run, left out of the path)
    def tapped_path():
        tap = engine(mesh)
        _admit_all(tap, prompts)
        tap.decode_round()

    _, reads = tapped(tapped_path)
    torch.cuda.empty_cache()
    calls = {op: r["calls"] for op, r in reads.items()}
    checks["(a) the first round's per-rank K2 calls and the admissions' K3 "
           "calls equal their plain versions"] = \
        calls == {"flash_attention": L * len(prompts),
                  "paged_attention_slab": L * n} and \
        all(r["err"] <= r["limit"] for r in reads.values())
    log(f"{tag} (a) every kernel call vs its plain version: "
        + _fmt_reads(reads))

    # (b) a cross-group fork: group 0's slots full, the child lands in
    # group 1 and its blocks are copied across ranks in the round's drain
    eng = engine(mesh)
    cache = eng.cache
    xs = _admit_all(eng, [p[:CROSS_PROMPT] for p in prompts])
    eng.decode_round()
    parent = next(s for s in xs if cache.seqs[s].group == 0)
    # CoW children fill the parent's group (shares, nothing moves)
    eng.fork(parent, len(cache._free_slots[0]))
    eng.decode_round()
    checks["(b) group 0's slots full, group 1's not"] = \
        not cache._free_slots[0] and bool(cache._free_slots[1])
    before = cache.seqs[parent].length
    kid = eng.fork(parent, 1)[0]
    e0, c0 = len(events), _counts()
    fd.add_launch_hook(hook)
    try:
        eng.decode_round()
        torch.cuda.synchronize()
    finally:
        fd.remove_launch_hook(hook)
    ran = _since(c0)
    for k, v in ran.items():
        path[k] = path.get(k, 0) + v
    page = eng.rc.page_size
    same = True
    for j, (bp, bk) in enumerate(zip(cache.blocks_of(parent),
                                     cache.blocks_of(kid))):
        upto = min(page, before - j * page)
        if upto <= 0:
            break
        for name in ("k", "v"):
            a = eng.engine.block(name, bp)[:, :upto]
            b = eng.engine.block(name, bk)[:, :upto]
            same = same and _bitwise_equal(a, b)
    kid_ranks = sorted({b // ss for b in cache.blocks_of(kid)})
    par_ranks = sorted({b // ss for b in cache.blocks_of(parent)})
    checks["(b) the cross-group child lies in group 1"] = \
        cache.seqs[kid].group == 1 and all(
            cache.group_of_block(b) == 1 for b in cache.blocks_of(kid))
    checks["(b) its copies rode the round's single drain with K7"] = \
        events[e0:] == ["fused_mesh"] and ran["psm_transfer"] > 0
    checks["(b) the child's blocks equal the parent's, bitwise"] = same
    log(f"{tag} (b) fork of sequence {parent} (group 0, ranks {par_ranks}) "
        f"with group 0 full: child {kid} in group "
        f"{cache.seqs[kid].group} on ranks {kid_ranks}; the round: "
        f"{events[e0:]}, K7 {ran['psm_transfer']}, K1 "
        f"{ran['fused_dispatch']}; {before} positions bitwise {same}")
    # (d) a round with bulk work: another cross-group fork, profiled.  The
    # counters hold that K7 and K1 ran; the trace may drop a launch
    # (ROADMAP §3), and then their device ms read "not in the trace"
    if cache._free_slots[1]:
        eng.fork(parent, 1)
        c0 = _counts()
        bulk = _profile_mesh_round(eng.decode_round, tag + " bulk round")
        ran = _since(c0)
        checks["(d) K7 and K1 launched in the profiled bulk round"] = \
            ran["psm_transfer"] > 0 and ran["fused_dispatch"] > 0
        lost = [k for k in ("K7_ms", "K1_ms") if not bulk.get(k)]
        log(f"{tag} bulk round (d) K7 {ran['psm_transfer']} and K1 "
            f"{ran['fused_dispatch']} launches by the counters; "
            + (f"{lost} not in the trace" if lost else
               "both in the trace"))
    del eng, cache
    torch.cuda.empty_cache()

    # (c) a replicated 3-slot ring against the single-device engine with
    # the same ring
    rprompts = [rng.integers(2, cfg.vocab_size, size=REPL_PROMPT).astype(
        np.int32) for _ in range(REPL_ROUNDS)]
    one = engine(None, max_admit_pages=REPL_RING)
    ref_toks, ref_logits = [], []
    for p in rprompts:
        one.add_request(p)
        ref_logits.append({s: lg.copy() for s, lg in one.last_logits.items()})
        ref_toks.append(one.decode_round())
    del one
    torch.cuda.empty_cache()
    eng = engine(mesh, max_admit_pages=REPL_RING)
    watch = _GreedyWatch()
    rounds = []
    fd.add_launch_hook(hook)
    try:
        for p, toks in zip(rprompts, ref_toks):
            e0 = len(events)
            eng.add_request(p)
            watch.round(toks)
            eng.decode_round(sample_fn=watch)
            rounds.append(events[e0:])
    finally:
        fd.remove_launch_hook(hook)
    torch.cuda.synchronize()
    steps, ties, bad, worst, limit = _compare_greedy(ref_logits, ref_toks,
                                                     watch, tag)
    checks["(c) the 3-slot ring is replicated on every rank"] = \
        eng.engine.group["k_stage"].sharding == () and \
        len(eng.engine.slabs("k_stage")) == n and \
        eng.engine.stage_capacity == REPL_RING
    checks["(c) one fused_mesh drain a round"] = all(
        r == ["fused_mesh"] for r in rounds)
    checks["(c) tokens equal the single-device engine's with the same ring "
           "(or differ at logged near-ties)"] = bad == 0 and worst <= limit
    log(f"{tag} (c) replicated {REPL_RING}-slot ring, {REPL_ROUNDS} rounds "
        f"of one {REPL_PROMPT}-token admission: drains {rounds}; {steps} "
        f"steps, {ties} near-ties, {bad} unexcused, max |logit diff| "
        f"{worst:.3e} (limit {limit:.3e})")
    del eng
    torch.cuda.empty_cache()
    log(f"{tag} phase 22 took {time.perf_counter() - t_phase:.1f} s")
    for name, ok in checks.items():
        log(f"{tag} {'ok  ' if ok else 'FAIL'} {name}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"mesh serving checks failed: {failed}")
    return {"llama3.2-3b mesh serve": path}


# ---------------------------------------------------------------------------
# phase 23: the model layer over a rank mesh (prefill_state / decode_state
# over slabs for vlm, hybrid and encdec; moe_ffn's all-to-all in a mesh
# engine)
# ---------------------------------------------------------------------------

#: (a) the facade legs: arch -> (text tokens a prompt, whether it takes
#: patches, source frames); B = 4 over (2, 4) ranks of ("data", "model")
FACADE_MESH_LEGS = (("paligemma-3b", VLM_TEXT), ("zamba2-2.7b", SSM_PROMPT),
                    ("seamless-m4t-medium", ENC_TEXT))
FACADE_MESH_B, FACADE_MESH_STEPS = 4, 16
#: decode room past the prompt: 128 tokens keeps the 4 sequences' block
#: count a multiple of the 8 ranks (the reference's shard_map condition)
FACADE_MARGIN = 128
#: (b) deepseek-moe-16b over ("model",) 8: the admissions (the all-to-all
#: where 8 divides the length, else the local path) and the rounds
MOE_MESH_RANKS, MOE_MESH_LENS, MOE_MESH_ROUNDS = 8, (96, 384, 250, 512), 8
#: (b) the captured layer of the 384-token admission
MOE_CAPTURE_LEN, MOE_CAPTURE_LAYER = 384, 14
#: (b) decode rounds of deepseek over ("data",) 8 (the FSDP path: one
#: local FFN a batch row and layer) and on one device, the same prompts
MOE_DATA_ROUNDS = 4
#: (b) card against CPU outputs of one bf16 moe layer: the moe tests' bf16
#: tolerance (tests/test_torch_moe.py DTYPES)
MOE_BF16_ATOL, MOE_BF16_RTOL = 2e-2, 2.0 ** -7


def _facade_inputs(cfg, rng, B: int, S: int) -> tuple:
    """tokens (B, S) and the family's extra input on the card: patch
    embeddings (vlm) or ``S // src_frames_ratio`` source frames (encdec),
    N(0, 1) x 0.02 from the seed, as phases 14 and 16."""
    tokens = torch.from_numpy(rng.integers(2, cfg.vocab_size, (B, S))).cuda()
    extra = {}
    n = {"vlm": cfg.vision_tokens,
         "encdec": max(S // max(cfg.src_frames_ratio, 1), 1)}.get(cfg.family)
    if n:
        a = (rng.standard_normal((B, n, cfg.d_model)) * 0.02).astype(
            np.float32)
        key = "patch_embeds" if cfg.family == "vlm" else "src_embeds"
        extra[key] = torch.from_numpy(a).cuda()
    return tokens, extra


def _facade_mesh_leg(arch: str, text: int, mesh, smi: str) -> dict:
    """(a) one facade leg: the single-device facade, then the same prompts
    over ``mesh`` fed its greedy tokens; returns the mesh run's launches."""
    from repro_torch.configs import get_config
    from repro_torch.weights import init_params
    cfg = get_config(arch)
    tag = f"[{arch} mesh facade]"
    n = mesh.size
    model = init_params(cfg, seed=SEED, device="cuda")
    tokens, extra = _facade_inputs(cfg, np.random.default_rng(SEED),
                                   FACADE_MESH_B, text)
    L = cfg.num_attn_layers
    prefill_k3 = {"vlm": L, "hybrid": L,
                  "encdec": cfg.encoder_layers + 2 * L}[cfg.family]
    checks = {}

    def prefill(m=None):
        return model.prefill_state(tokens, margin_tokens=FACADE_MARGIN,
                                   mesh=m, **extra)

    # the single-device facade: its logits and greedy tokens
    logits, state = prefill()
    ref_logits, toks, one_ms = [logits], [], []
    for _ in range(FACADE_MESH_STEPS):
        toks.append(ref_logits[-1].argmax(-1))
        t = time.perf_counter()
        logits, state = model.decode_state(state, toks[-1])
        torch.cuda.synchronize()
        one_ms.append((time.perf_counter() - t) * 1e3)
        ref_logits.append(logits)
    nblk = state["base"].shape[0]
    del state
    # the mesh: prefill over slabs, the same tokens
    c0 = _counts()
    logits, state = prefill(mesh)
    pre = _since(c0)
    got, mesh_ms, k2 = [logits], [], []
    for step in range(FACADE_MESH_STEPS):
        c1 = _counts()
        t = time.perf_counter()
        logits, state = model.decode_state(state, toks[step], mesh=mesh)
        torch.cuda.synchronize()
        mesh_ms.append((time.perf_counter() - t) * 1e3)
        k2.append(_since(c1)["paged_attention"])
        got.append(logits)
    path = _since(c0)
    slabs = state["k_pools"]
    checks[f"{n} slabs of {nblk // n} blocks, mask columns "
           f"{FACADE_MESH_B // 2}"] = \
        len(slabs) == n and all(s.shape[1] == nblk // n for s in slabs) and \
        state["share_mask"].shape[1] == FACADE_MESH_B // 2
    checks[f"prefill: K3 == {prefill_k3}, no K2"] = \
        pre["flash_attention"] == prefill_k3 and pre["paged_attention"] == 0
    if cfg.family == "hybrid":
        checks[f"prefill: K4 == {cfg.num_layers}"] = \
            pre["ssd_intra_chunk"] == cfg.num_layers
    checks[f"decode: K2 == {L} x {n} = {L * n} a step"] = \
        all(k == L * n for k in k2)
    worst, limit, flips, bad = 0.0, 0.0, [], 0
    for step, (a, b) in enumerate(zip(got, ref_logits)):
        diff = float((a - b).abs().max())
        worst = max(worst, diff)
        limit = max(limit, SERVE_RTOL * float(b.abs().max()))
        for s in (a.argmax(-1) != b.argmax(-1)).nonzero()[:, 0].tolist():
            margin = _top2(b[s].float().cpu().numpy())
            flips.append((step, s, margin))
            # a near-tie: within twice the two runs' |logit diff| there
            bad += margin > 2 * float((a[s] - b[s]).abs().max())
    checks["logits within SERVE_RTOL x max |logit| of the single-device "
           "facade's"] = worst <= limit and all(
        bool(torch.isfinite(g).all()) for g in got)
    checks["greedy tokens equal the single-device facade's but at "
           "near-ties"] = bad == 0
    med = lambda xs: float(np.median(xs[1:]))
    log(f"{tag} {FACADE_MESH_B} x {tuple(tokens.shape)[1]} tokens"
        f"{' + ' + str(cfg.vision_tokens) + ' patches' if 'patch_embeds' in extra else ''}"
        f"{' over ' + str(extra['src_embeds'].shape[1]) + ' frames' if 'src_embeds' in extra else ''}"
        f", margin {FACADE_MARGIN}: {nblk} blocks in {n} slabs of "
        f"{nblk // n}, mask columns {state['share_mask'].shape[1]}; prefill "
        f"K3 {pre['flash_attention']} K4 {pre['ssd_intra_chunk']}; K2 a step"
        f" {sorted(set(k2))}; logits vs single device over the prefill and "
        f"{FACADE_MESH_STEPS} steps: max |diff| {worst:.3e} (limit "
        f"{limit:.3e}); argmax mismatches (step, sequence, single top-1 / "
        f"top-2 margin) {flips or 'none'}, {bad} beyond twice the "
        "sequence's |logit diff|")
    log(f"{tag} ms a step (steps 2-{FACADE_MESH_STEPS}, median, host clock, "
        f"synchronised), {smi}: mesh {med(mesh_ms):.2f} ms, single device "
        f"{med(one_ms):.2f} ms ({med(mesh_ms) / med(one_ms):.2f}x)")
    tok = toks[-1]
    prof = _profile_mesh_round(
        lambda: model.decode_state(state, tok, mesh=mesh), tag)
    checks["the profile saw K2"] = prof.get("K2_ms", 0) > 0
    del state, got, ref_logits

    # every K2 / K3 / K4 call of the prefill and the first step against its
    # plain version (a check run, left out of the path)
    def taps():
        _, st = prefill(mesh)
        model.decode_state(st, toks[0], mesh=mesh)

    _, reads = tapped(taps)
    # an encdec step adds one K3 call a layer (one query over the frames)
    want = {"flash_attention": prefill_k3 + (L if cfg.family == "encdec"
                                              else 0),
            "paged_attention_slab": L * n}
    if cfg.family == "hybrid":
        want["ssd_intra_chunk"] = cfg.num_layers
    checks["every K2 / K3 / K4 call of the prefill and the first step "
           "equals its plain version"] = \
        {op: r["calls"] for op, r in reads.items()} == want and \
        all(r["err"] <= r["limit"] for r in reads.values())
    log(f"{tag} every kernel call vs its plain version: "
        + _fmt_reads(reads))
    del model
    torch.cuda.empty_cache()
    for name, ok in checks.items():
        log(f"{tag} {'ok  ' if ok else 'FAIL'} {name}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{arch} mesh facade checks failed: {failed}")
    return path


class _RouteRecord:
    """Wraps ``moe.route_local`` while on: keeps each call's (idx, pos,
    keep) on the host, in call order (the ranks of an all-to-all)."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.saved, self.calls = moe, moe.route_local, []

    def __enter__(self):
        def call(*args, **kw):
            out = self.saved(*args, **kw)
            self.calls.append(tuple(t.cpu() for t in out[1:4]))
            return out
        self.moe.route_local = call
        return self

    def __exit__(self, *exc):
        self.moe.route_local = self.saved


def _moe_rounds(cfg, model, mesh, prompts) -> dict:
    """Admit ``prompts`` into a ``ServingEngine`` over ``mesh`` (None: one
    device) and run :data:`MOE_DATA_ROUNDS` decode rounds: the ms of each
    round, the moe path counts of each, the launches of the admissions and
    rounds, and each sequence's logits after round 1."""
    from repro_torch.launch.serve import ServingEngine
    from repro_torch.models import moe
    c0 = _counts()
    eng = ServingEngine(cfg, model, max_seqs=MAX_SEQS,
                        max_blocks_per_seq=MAX_BLOCKS_PER_SEQ, mesh=mesh,
                        device="cuda")
    for p in prompts:
        eng.add_request(p)
    out = {"ms": [], "paths": []}
    for r in range(MOE_DATA_ROUNDS):
        moe.PATH_COUNTS.clear()
        t = time.perf_counter()
        eng.decode_round()
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t) * 1e3)
        out["paths"].append(dict(moe.PATH_COUNTS))
        if r == 0:
            out["logits"] = {s: lg.copy() for s, lg in
                             eng.last_logits.items()}
    out["launches"] = _since(c0)
    del eng
    torch.cuda.empty_cache()
    return out


def _moe_mesh_leg(smi: str) -> dict:
    """(b) deepseek-moe-16b in ``ServingEngine(mesh=)`` over ("model",) 8
    ranks of the card; returns the launches of the admissions and rounds."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.serve import ServingEngine
    from repro_torch.models import moe, transformer
    from repro_torch.weights import init_params
    arch = "deepseek-moe-16b"
    tag = f"[{arch} mesh serve]"
    cfg = get_config(arch)
    L, T = cfg.num_layers, MOE_MESH_RANKS
    mesh = make_test_mesh((T,), ("model",), devices="cuda")
    model = init_params(cfg, seed=SEED, device="cuda")
    eng = ServingEngine(cfg, model, max_seqs=MAX_SEQS,
                        max_blocks_per_seq=MAX_BLOCKS_PER_SEQ, mesh=mesh)
    rng = np.random.default_rng(SEED + 23)
    prompts = [rng.integers(2, cfg.vocab_size, size=k).astype(np.int32)
               for k in MOE_MESH_LENS]
    checks, taken, captured = {}, [], {}
    saved_ffn = transformer.moe_ffn

    def capture(p, x, cfg_, mesh_=None):
        if x.shape[1] == MOE_CAPTURE_LEN:
            i = captured.setdefault("calls", 0)
            if i == MOE_CAPTURE_LAYER:
                captured["x"] = x.clone()
            captured["calls"] = i + 1
        return saved_ffn(p, x, cfg_, mesh_)

    transformer.moe_ffn = capture
    c0 = _counts()
    try:
        for p in prompts:
            moe.PATH_COUNTS.clear()
            eng.add_request(p)
            taken.append(dict(moe.PATH_COUNTS))
    finally:
        transformer.moe_ffn = saved_ffn
    k2, ms = [], []
    for _ in range(MOE_MESH_ROUNDS):
        c1 = _counts()
        t = time.perf_counter()
        eng.decode_round()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        k2.append(_since(c1)["paged_attention"])
    path = _since(c0)
    want = [{"a2a" if len(p) % T == 0 else "local": L} for p in prompts]
    checks[f"each admission's FFN took the a2a path exactly where {T} "
           "divides its length"] = taken == want
    checks[f"decode: K2 == {L} x {T} a round"] = all(k == L * T for k in k2)
    checks["logits finite"] = all(np.isfinite(lg).all()
                                  for lg in eng.last_logits.values())
    log(f"{tag} {T} ranks on cuda:0 over ('model',), E_l = "
        f"{cfg.num_experts // T}; admissions {MOE_MESH_LENS}: paths "
        f"{taken}; {MOE_MESH_ROUNDS} rounds, K2 a round {sorted(set(k2))}, "
        f"K1 {path['fused_dispatch']}, K7 {path['psm_transfer']}, K3 "
        f"{path['flash_attention']}; ms a round (rounds 2-"
        f"{MOE_MESH_ROUNDS}, median, host clock), {smi}: "
        f"{float(np.median(ms[1:])):.2f}")
    # one layer's all-to-all on the captured input: the card's 8 ranks
    # against 8 CPU ranks (check runs, left out of the path)
    layer = model.layers[MOE_CAPTURE_LAYER].moe
    x = captured["x"]
    with _RouteRecord() as card:
        y_card, aux_card = moe.moe_ffn_a2a(layer, x, cfg, mesh)
    y_local, _ = moe.moe_ffn_local(layer, x, cfg)
    del eng
    torch.cuda.empty_cache()

    # decode rounds over ("data",) T: every round's FFN takes the FSDP
    # path, one moe_ffn_local a batch row; against one device's engine
    runs = {name: _moe_rounds(cfg, model, m, prompts) for name, m in (
        ("one device", None),
        ("data", make_test_mesh((T,), ("data",), devices="cuda")))}
    one, dat = runs["one device"], runs["data"]
    worst = max(float(np.abs(dat["logits"][s] - lg).max())
                for s, lg in one["logits"].items())
    limit = SERVE_RTOL * max(float(np.abs(lg).max())
                             for lg in one["logits"].values())
    checks[f"('data',) {T}: every round's FFN takes the fsdp path, one "
           "device's the local path"] = \
        all(p == {"fsdp": L} for p in dat["paths"]) and \
        all(p == {"local": L} for p in one["paths"])
    checks[f"('data',) {T}: K2 == {L} x {T} a round, one device's {L}"] = \
        dat["launches"]["paged_attention"] == L * T * MOE_DATA_ROUNDS and \
        one["launches"]["paged_attention"] == L * MOE_DATA_ROUNDS
    checks[f"('data',) {T}: round 1's logits within SERVE_RTOL x max "
           "|logit| of one device's"] = \
        set(dat["logits"]) == set(one["logits"]) and worst <= limit
    med = lambda xs: float(np.median(xs[1:]))
    log(f"{tag} ('data',) {T} ranks on cuda:0, {MOE_DATA_ROUNDS} rounds of "
        f"{MAX_SEQS} rows after admitting {MOE_MESH_LENS}: paths a round "
        f"{dat['paths'][0]} (one device {one['paths'][0]}); K2 "
        f"{dat['launches']['paged_attention']} (one device "
        f"{one['launches']['paged_attention']}); round 1 logits max |diff| "
        f"{worst:.3e} (limit "
        f"{limit:.3e}); ms a round (rounds 2-{MOE_DATA_ROUNDS}, median, "
        f"host clock), {smi}: ('data',) fsdp {med(dat['ms']):.2f}, one "
        f"device local {med(one['ms']):.2f} "
        f"({med(dat['ms']) / med(one['ms']):.2f}x)")
    del model
    torch.cuda.empty_cache()
    cpu_layer = moe.MoEFFN(cfg, x.dtype, "cpu")
    cpu_layer.load_state_dict({k: v.cpu() for k, v in
                               layer.state_dict().items()})
    del layer
    torch.cuda.empty_cache()
    cpu_mesh = make_test_mesh((T,), ("model",), devices="cpu")
    t = time.perf_counter()
    with _RouteRecord() as host:
        y_cpu, aux_cpu = moe.moe_ffn_a2a(cpu_layer, x.cpu(), cfg, cpu_mesh)
    cpu_s = time.perf_counter() - t
    same = [all(torch.equal(a, b) for a, b in zip(r1, r2))
            for r1, r2 in zip(card.calls, host.calls)]
    kept = sum(int(r[2].sum()) for r in card.calls)
    choices = sum(r[2].numel() for r in card.calls)
    yc, yh = y_card.float().cpu(), y_cpu.float()
    err = float((yc - yh).abs().max())
    ok_y = bool(((yc - yh).abs() <= MOE_BF16_ATOL
                 + MOE_BF16_RTOL * yh.abs()).all())
    yl = y_local.float().cpu()
    rows = int(((yl - yc).abs() > MOE_BF16_ATOL
                + MOE_BF16_RTOL * yc.abs()).any(-1).sum())
    checks[f"layer {MOE_CAPTURE_LAYER}'s all-to-all: the kept routes (idx, "
           f"pos, keep) of every rank equal over {T} card and {T} CPU "
           "ranks"] = len(card.calls) == len(host.calls) == T and all(same)
    checks["its output within the bf16 tolerance of the CPU ranks'"] = \
        ok_y and bool(torch.isfinite(yc).all())
    log(f"{tag} layer {MOE_CAPTURE_LAYER}, the {MOE_CAPTURE_LEN}-token "
        f"admission's input: {T} card ranks vs {T} CPU ranks "
        f"({cpu_s:.1f} s on the CPU): routes equal per rank {same}, "
        f"{kept} of {choices} choices kept; max |y diff| {err:.3e} (atol "
        f"{MOE_BF16_ATOL} + rtol {MOE_BF16_RTOL:.3e}); aux {float(aux_card):.6f}"
        f" vs {float(aux_cpu):.6f}; {rows} of {x.shape[1]} rows differ from "
        "moe_ffn_local on the same input")
    for name, ok in checks.items():
        log(f"{tag} {'ok  ' if ok else 'FAIL'} {name}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{arch} mesh serve checks failed: {failed}")
    return {f"{arch} mesh serve": path,
            f"{arch} data-mesh serve": dat["launches"]}


def phase_mesh_model(smi: str) -> dict:
    """Phase 23: the model layer over ranks that share the card.  Returns
    the launch counts of each leg's counted run."""
    from repro_torch.launch.mesh import make_test_mesh
    t_phase = time.perf_counter()
    mesh = make_test_mesh(MESH_SERVE_SHAPE, MESH_SERVE_AXES, devices="cuda")
    paths = {}
    for arch, text in FACADE_MESH_LEGS:
        paths[f"{arch} mesh facade"] = _facade_mesh_leg(arch, text, mesh,
                                                        smi)
    paths.update(_moe_mesh_leg(smi))
    log(f"[mesh model] phase 23 took {time.perf_counter() - t_phase:.1f} s")
    return paths


# ---------------------------------------------------------------------------
# phase 25: the dry-run (launch/dryrun.py, launch/op_cost.py, kernels/cost.py)
# ---------------------------------------------------------------------------

#: (a) the walked step against the real one: phase 21's cell
DRY_ARCH, DRY_B, DRY_S = TRAIN_ARCH, TRAIN_B, TRAIN_S
#: (a) the walk's peak against ``max_memory_allocated``: within 10% (the
#: caching allocator rounds each block up and holds cuBLAS's workspace)
DRY_PEAK_RTOL = 0.10
#: (c) the sweep's share of the phase: seconds, worker processes (every
#: serving cell is placed: the cheapest prefill_32k cell,
#: paligemma-3b's, walks in 50-65 s on a CPU, over 80 s on a slow host),
#: and the seconds its running cells may go on past them while no cell
#: of a kind of DRY_SWEEP_KINDS has walked to ok
DRY_SWEEP_S, DRY_WORKERS, DRY_SWEEP_GRACE_S = 80.0, 6, 60.0
DRY_SWEEP_KINDS = frozenset({"prefill_32k", "decode_32k"})


class _NoModules:
    """``FlopCounterMode``'s module tracker, without the module hooks:
    they refuse the ``autograd.grad`` a training step calls inside its
    forward; every count goes to the global total."""

    parents = {"Global"}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


def _dry_walk(cfg, shape, mesh):
    from repro_torch.launch.dryrun import analyse, walk_cell
    walk, _, t_walk = walk_cell(cfg, shape, mesh)
    return walk, analyse(walk, cfg, shape, mesh.size), t_walk


def _sweep_cells() -> list:
    """Every (arch, shape) of the ``--mesh single`` sweep, cheapest first:
    the serving cells (every family's weights placed: each rank computes
    its blocks) by their layers, a Mamba2 stack's prefill eight times its
    layers (each rank loops over the chunks of its sequence), then the
    train cells by their layers' attention blocks (256 a layer over 16 x
    16 ranks; an ssm stack has none)."""
    from repro_torch.configs import SHAPES, get_config, list_archs

    def weight(cell):
        cfg, shape = get_config(cell[0]), SHAPES[cell[1]]
        layers = cfg.num_layers + cfg.encoder_layers
        if shape.kind == "train":
            return (1, cfg.num_attn_layers + cfg.encoder_layers, cell)
        if shape.kind == "prefill" and cfg.family in ("ssm", "hybrid"):
            layers *= 8
        return (0, layers, cell)

    return sorted(((a, s) for a in list_archs() for s in SHAPES), key=weight)


def _sweep_kinds_ok(rows) -> bool:
    """Whether a cell of every kind of :data:`DRY_SWEEP_KINDS` walked to
    ok."""
    return {r["shape"] for r in rows if r["status"] == "ok"} >= \
        DRY_SWEEP_KINDS


def dry_sweep(budget_s: float, workers: int, grace_s: float = 0.0) -> dict:
    """``python -m repro_torch.launch.dryrun --mesh single`` over every
    cell, one process a cell, ``workers`` at once, for ``budget_s``
    seconds (and the cells then running for up to ``grace_s`` more while
    :func:`_sweep_kinds_ok` is not yet true): a cell still running then is
    stopped and counted as not finished.  Returns the rows and the
    counts."""
    import os
    import tempfile
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cells, running, rows = _sweep_cells(), [], []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        def start(arch, shape):
            out = os.path.join(tmp, f"{arch}.{shape}.jsonl")
            proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", arch, "--shape", shape, "--mesh", "single",
                 "--out", out], env=env, stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL)
            running.append((proc, out, arch, shape, time.perf_counter()))

        def reap(proc, out, arch, shape, t_start):
            if os.path.exists(out):
                with open(out) as f:
                    rows.extend(json.loads(line) for line in f)
            else:
                rows.append({"arch": arch, "shape": shape, "mesh": "16x16",
                             "status": "error",
                             "error": f"exit {proc.returncode}"})

        try:
            while cells or running:
                while cells and len(running) < workers and \
                        time.perf_counter() - t0 < budget_s:
                    start(*cells.pop(0))
                for item in list(running):
                    if item[0].poll() is not None:
                        running.remove(item)
                        reap(*item)
                elapsed = time.perf_counter() - t0
                if elapsed >= budget_s and (
                        elapsed >= budget_s + grace_s or not running
                        or _sweep_kinds_ok(rows)):
                    break
                time.sleep(0.2)
        finally:
            for proc, *_ in running:
                proc.kill()
                proc.wait()
    n = {s: sum(r["status"] == s for r in rows)
         for s in ("ok", "skip", "error")}
    n["not finished"] = len(running) + len(cells)
    n["seconds"] = time.perf_counter() - t0
    return {"rows": rows, "counts": n}


def _log_sweep(sweep: dict, tag: str) -> None:
    """One line a row of :func:`dry_sweep`."""
    for r in sweep["rows"]:
        what = r.get("dominant") or r.get("reason") or r.get("error", "")
        extra = ""
        if r["status"] == "ok":
            extra = (f"; busiest rank {r['busiest_rank']}: t_compute "
                     f"{r['t_compute_s'] * 1e3:.3f} / t_memory "
                     f"{r['t_memory_s'] * 1e3:.3f} / t_peer "
                     f"{r['t_collective_s'] * 1e3:.3f} ms, temp "
                     f"{r['memory']['temp_size_in_bytes'] / 2 ** 30:.2f} "
                     f"GiB, walk {r['compile_s']} s")
        log(f"{tag} (c) {r['arch']} {r['shape']}: {r['status']} "
            f"{str(what)[:100]}{extra}")


def phase_dryrun(smi: str) -> None:
    """Phase 25: the dry-run.  (a) llama3.2-3b at phase 21's cell, the
    placed step over (2, 4) ranks of the card (``"fsdp"``): the walk over
    ``meta`` ranks sharing one device (``Walk(one_device=True)``) against
    the real step, in the same call: its peak against
    ``max_memory_allocated``, its FLOPs over the ranks against
    ``FlopCounterMode``'s over the step (equal: the same formulas over the
    same ops), its roofline time (every rank's FLOPs and bytes on one
    card) against the step's device busy ms (a bound: at most the busy
    time).  (b) phase 5's serving cells at
    full width: one decode round's K2 calls (8 sequences x 64 blocks, the
    identity layout full) and a 512-token prefill's K3 calls, the walk's
    bytes a call equal to the bound bytes of phases 2 and 4's rule over
    card tensors of the same call.  (c) the ``--mesh single`` sweep, as
    much of it as :data:`DRY_SWEEP_S` holds (longer, up to
    :data:`DRY_SWEEP_GRACE_S`, until a cell of each kind is ok), in
    processes beside (a) and (b)."""
    tag = "[dry-run]"
    t_phase = time.perf_counter()
    checks = {}
    # (c) the sweep, in processes beside (a) and (b), read after them
    box = {}

    def sweep_run():
        try:
            box["sweep"] = dry_sweep(DRY_SWEEP_S, DRY_WORKERS,
                                     DRY_SWEEP_GRACE_S)
        except BaseException as e:      # re-raised in the phase
            box["error"] = e

    sweeper = threading.Thread(target=sweep_run)
    sweeper.start()
    try:
        _dryrun_walk_checks(smi, checks, tag)
    finally:
        sweeper.join()
    if "error" in box:
        raise box["error"]

    # (c) the sweep -----------------------------------------------------
    sweep = box["sweep"]
    _log_sweep(sweep, tag)
    n = sweep["counts"]
    log(f"{tag} (c) --mesh single sweep: {n['ok']} ok, {n['skip']} skip, "
        f"{n['error']} error, {n['not finished']} not finished in "
        f"{n['seconds']:.1f} s ({DRY_WORKERS} processes, a "
        f"{DRY_SWEEP_S:.0f} s budget, up to {DRY_SWEEP_GRACE_S:.0f} s more "
        "for a cell of each kind; beside (a) and (b))")
    checks["(c) no sweep cell errs"] = n["error"] == 0
    checks["(c) the sweep reached a cell of each kind"] = \
        _sweep_kinds_ok(sweep["rows"])
    log(f"{tag} phase 25 took {time.perf_counter() - t_phase:.1f} s")
    for name, ok in checks.items():
        log(f"{tag} {'ok  ' if ok else 'FAIL'} {name}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"dry-run checks failed: {failed}")


def _dryrun_walk_checks(smi: str, checks: dict, tag: str) -> None:
    """Phase 25 (a) and (b) (see :func:`phase_dryrun`)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import ShapeConfig, TrainConfig, get_config
    from repro_torch.data import batch_logical_axes, make_batch, to_device
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.train import build_train_step, train_state
    from repro_torch.models.paged import identity_layout
    from repro_torch.weights import init_params, params_axes
    one = make_test_mesh((1, 1), devices="meta")
    gb = 1e9

    # (a) the walk against the real placed step ---------------------------
    cfg = get_config(DRY_ARCH)
    walk, t_walk = _mesh_walk(cfg, TrainConfig(), DRY_B, DRY_S)
    walk_peak, walk_flops = walk.peak_all, sum(walk.flops)
    walk_bytes = sum(walk.bytes)
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    model = init_params(cfg, seed=SEED, device="cuda",
                        param_dtype=torch.float32)
    mesh = make_test_mesh(MESH_TRAIN_SHAPE, MESH_TRAIN_AXES, devices="cuda")
    step, shard_state, _ = build_train_step(
        model, TrainConfig(), mesh, params_axes(model),
        batch_logical_axes(cfg))
    state = train_state(model, shard_state(dict(model.named_parameters())))
    batch = to_device(make_batch(cfg, DRY_B, DRY_S, 0), "cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    fc = FlopCounterMode(display=False)
    fc.mod_tracker = _NoModules()
    with fc:
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    real_flops = fc.get_total_flops()
    t0 = time.perf_counter()
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, batch)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == cuda) / 1e3
    del model, state, step, batch, fc, prof
    torch.cuda.empty_cache()
    # one card computes every rank's blocks: its roofline is the ranks'
    # FLOPs and bytes together
    t_roof = max(walk_flops / cost.BF16_FLOPS,
                 walk_bytes / cost.HBM_BYTES_PER_S) * 1e3
    log(f"{tag} (a) {DRY_ARCH} train B = {DRY_B} x S = {DRY_S}, the placed "
        f"step over {MESH_TRAIN_SHAPE} ranks of one device (\"fsdp\"): walk "
        f"{walk.ops:,} ops in {t_walk:.1f} s; peak {walk_peak / gb:.3f} GB "
        f"reckoned (arguments {sum(walk.arguments) / gb:.3f} GB), "
        f"max_memory_allocated {peak / gb:.3f} GB (ratio "
        f"{walk_peak / peak:.4f}); FLOPs {walk_flops:.6e} reckoned, "
        f"FlopCounterMode {real_flops:.6e}; HBM bytes {walk_bytes:.6e}; "
        f"roofline {t_roof:.2f} ms against the step's device busy "
        f"{busy:.2f} ms ({t_roof / busy:.3f} of it) and wall {step_ms:.1f} "
        f"ms ({smi})")
    checks.update({
        "(a) the walk's FLOPs equal FlopCounterMode's":
            walk_flops == real_flops,
        f"(a) the walk's peak within {DRY_PEAK_RTOL:.0%} of "
        "max_memory_allocated": abs(walk_peak / peak - 1) <= DRY_PEAK_RTOL,
        "(a) the roofline time at most the device busy time":
            0 < t_roof <= busy,
    })

    # (b) the serving cells' kernels at their boundary ------------------
    page, B, nper = 64, MAX_SEQS, MAX_BLOCKS_PER_SEQ
    S = nper * page
    dec = ShapeConfig("decode", S, B, "decode")
    walk, row, _ = _dry_walk(cfg, dec, one)
    k2 = row["kernels"]["K2"]
    _, mask, base = identity_layout(B, S, page)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q = torch.randn((B, cfg.num_heads, cfg.head_dim), generator=gen,
                    device="cuda").bfloat16()
    kv = torch.zeros((B * nper, page, cfg.num_kv_heads, cfg.head_dim),
                     dtype=torch.bfloat16, device="cuda")
    want2 = cost.k2_work(q, kv, kv, torch.from_numpy(mask).cuda(),
                         torch.from_numpy(base).cuda(),
                         torch.full((B,), S, dtype=torch.int32,
                                    device="cuda"), page=page)
    pre = ShapeConfig("prefill", 512, 1, "prefill")
    walk, row_p, _ = _dry_walk(cfg, pre, one)
    k3 = row_p["kernels"]["K3"]
    q3 = torch.zeros((1, cfg.num_heads, 512, cfg.head_dim),
                     dtype=torch.bfloat16, device="cuda")
    k3t = torch.zeros((1, cfg.num_kv_heads, 512, cfg.head_dim),
                      dtype=torch.bfloat16, device="cuda")
    want3 = cost.k3_work(q3, k3t, k3t)
    log(f"{tag} (b) decode round ({B} sequences x {nper} blocks, full): "
        f"K2 {k2['calls']} calls, {k2['bytes'] // k2['calls']:,} B a call "
        f"reckoned, {want2.bytes:,} B by phase 2's rule on the card's "
        f"tensors; prefill 1 x 512: K3 {k3['calls']} calls, "
        f"{k3['bytes'] // k3['calls']:,} B a call, {want3.bytes:,} B by "
        f"phase 4's; roofline of the decode step "
        f"{max(row['t_compute_s'], row['t_memory_s']) * 1e3:.3f} ms, of "
        f"the prefill "
        f"{max(row_p['t_compute_s'], row_p['t_memory_s']) * 1e3:.3f} ms "
        "(reckoned against the published peaks)")
    checks.update({
        "(b) K2 a decode round: one call a layer":
            k2["calls"] == cfg.num_layers,
        "(b) K2's bytes a call equal phase 2's rule":
            k2["bytes"] == want2.bytes * k2["calls"],
        "(b) K3 a prefill: one call a layer": k3["calls"] == cfg.num_layers,
        "(b) K3's bytes a call equal phase 4's rule (8,388,608)":
            k3["bytes"] == want3.bytes * k3["calls"]
            and want3.bytes == 8_388_608,
    })


# ---------------------------------------------------------------------------
# phase 26: the dense decoder's serving weights placed over a rank mesh
# (weights.place_params; prefill / decode_step / ServingEngine(mesh=) on
# the placed weights; K3's q_offset)
# ---------------------------------------------------------------------------

#: (e) K3's row block: the last 2,048 query rows of a 4,096 prefill
PLACED_K3_S, PLACED_K3_ROWS = 4096, 2048
#: (f) the dense cells walked again with placed weights, a process each
#: (the other dense cells, 60-296 s of walk each on a CPU, are left to the
#: CLI: the script keeps within its time)
PLACED_DRY_CELLS = (("llama3.2-3b", "prefill_32k"),
                    ("llama3.2-3b", "decode_32k"), ("yi-6b", "decode_32k"))
#: (f) what a rank of one H100 holds (80 GB), and the decode cells' bound
#: on a rank's arguments (its slabs and about 1/256 of the weights)
RANK_GIB, DECODE_ARGS_GIB = 74.5, 8.0
#: (f) seconds the walks may take
PLACED_DRY_TIMEOUT = 420


@contextlib.contextmanager
def _walking(cells):
    """:func:`_start_walks` into a temporary directory; every process still
    running when the block ends is stopped."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        walks = _start_walks(cells, tmp)
        try:
            yield walks
        finally:
            for proc, *_ in walks:
                if proc.poll() is None:
                    proc.kill()
                proc.wait()


def _start_walks(cells, out_dir):
    """One ``python -m repro_torch.launch.dryrun`` process a cell, all at
    once; returns them with their output files."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for arch, shape in cells:
        out = os.path.join(out_dir, f"{arch}.{shape}.jsonl")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "single", "--out", out],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE),
            out, arch, shape))
    return procs


def _walked_rows(walks, deadline: float) -> tuple:
    """Wait for :func:`_start_walks`' processes until ``deadline`` (on the
    ``perf_counter`` clock), stopping any still running then; returns the
    rows they wrote and the walks that failed (arch, shape, exit code or
    status, the end of their error output)."""
    import os
    rows, failed = [], []
    for proc, out_file, arch, shape in walks:
        try:
            proc.wait(timeout=max(deadline - time.perf_counter(), 1))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        if proc.returncode == 0 and os.path.exists(out_file):
            with open(out_file) as f:
                rows.extend(json.loads(line) for line in f)
        else:
            failed.append((arch, shape, proc.returncode,
                           proc.stderr.read()[-400:]))
        proc.stderr.close()
    failed += [(r["arch"], r["shape"], r["status"], r.get("error", "")[:200])
               for r in rows if r["status"] != "ok"]
    return [r for r in rows if r["status"] == "ok"], failed


def _placed_protocol(eng, prompts, events, watch=None, ref_toks=None,
                     counted=None, before_round=None) -> tuple:
    """Phase 5's protocol on ``eng`` for phases 26-27: admit ``prompts``,
    fork the first sequence into 2 before round 2, :data:`ROUNDS` rounds.
    ``watch`` (a :class:`_GreedyWatch`) feeds each round ``ref_toks``'
    tokens, ``before_round(eng)`` runs before each round, ``counted`` sums
    the run's launches.  Returns the sequence ids, each admission's K3
    launches, the admissions' moe paths, per round (the drains the launch
    hook put in ``events``, K1, K7, K2, the moe paths) and its ms
    (synchronised host clock), the tokens of each round (``watch`` None)
    and the logits each round chose from."""
    from repro_torch.models import moe
    k3, rounds, ms, toks, logits = [], [], [], [], []
    c_all = _counts()
    sids = []
    moe.PATH_COUNTS.clear()
    for p in prompts:
        c0 = _counts()
        sids.append(eng.add_request(p))
        k3.append(_since(c0)["flash_attention"])
    admitted = dict(moe.PATH_COUNTS)
    for rnd in range(ROUNDS):
        if rnd == 1:
            eng.fork(sids[0], 2)
        if before_round is not None:
            before_round(eng)
        logits.append({s: lg.copy() for s, lg in eng.last_logits.items()})
        e0, c0 = len(events), _counts()
        moe.PATH_COUNTS.clear()
        t = time.perf_counter()
        if watch is None:
            toks.append(eng.decode_round())
        else:
            watch.round(ref_toks[rnd])
            eng.decode_round(sample_fn=watch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        ran = _since(c0)
        rounds.append((events[e0:], ran["fused_dispatch"],
                       ran["psm_transfer"], ran["paged_attention"],
                       dict(moe.PATH_COUNTS)))
    if counted is not None:
        for k, v in _since(c_all).items():
            counted[k] = counted.get(k, 0) + v
    return sids, k3, admitted, rounds, ms, toks, logits


def phase_placed_serve(params, smi: str, scrub) -> dict:
    """Phase 26: llama3.2-3b's weights placed over (2, 4) ranks of the card
    (``weights.place_params`` under ``DEFAULT_RULES``) and served by
    ``ServingEngine(mesh=)``, each rank computing its blocks, at full
    width and depth, against the single-device engine on phase 5's
    weights (the same seed).  Returns the launch counts of the placed
    engine's run."""
    import torch.nn.functional as F
    from repro_torch.kernels import fused_dispatch as fd
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import Sharded, make_test_mesh, rank_bytes
    from repro_torch.launch.serve import ServingEngine
    from repro_torch.sharding.rules import attn_strategy
    from repro_torch.weights import init_params, place_params
    tag = "[llama3.2-3b placed]"
    t_phase = time.perf_counter()
    cfg = params.cfg
    L = cfg.num_layers
    mesh = make_test_mesh(MESH_SERVE_SHAPE, MESH_SERVE_AXES, devices="cuda")
    n = mesh.size
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(2, cfg.vocab_size, size=k).astype(np.int32)
               for k in PROMPT_LENS]
    checks, path = {}, {}
    events = []
    hook = lambda n_, p_, mech: events.append(mech)

    def engine(model, m):
        return ServingEngine(cfg, model, max_seqs=MAX_SEQS,
                             max_blocks_per_seq=MAX_BLOCKS_PER_SEQ, mesh=m)

    def serve(eng, watch=None, counted=None):
        return _placed_protocol(eng, prompts, events, watch, ref_toks,
                                counted)

    steady = lambda xs: float(np.median(xs[2:]))
    ref_toks = None
    fd.add_launch_hook(hook)
    try:
        # (a) the single-device engine, then phase 22's unplaced mesh
        # engine, on phase 5's weights
        one = engine(params, None)
        sids, _, _, _, one_ms, ref_toks, ref_logits = serve(one)
        del one
        torch.cuda.empty_cache()
        whole = engine(params, mesh)
        _, _, _, _, whole_ms, whole_toks, _ = serve(whole)
        del whole
        torch.cuda.empty_cache()
        # (b) the weights placed: a second copy made from the same seed
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        model = place_params(init_params(cfg, seed=SEED, device="cuda"),
                             mesh)
        placed_peak = torch.cuda.max_memory_allocated() - held
        values = list(model.placement.values.values())
        at_rest = rank_bytes(values, mesh)
        total = sum(at_rest)
        split = sum(isinstance(v, Sharded) for v in values)
        torch.cuda.reset_peak_memory_stats()
        eng = engine(model, mesh)
        watch = _GreedyWatch()
        msids, k3_per, _, per_round, placed_ms, _, _ = serve(eng, watch,
                                                             path)
        serve_peak = torch.cuda.max_memory_allocated()
    finally:
        fd.remove_launch_hook(hook)
    strategy = attn_strategy(cfg.num_heads, mesh)
    log(f"{tag} card {smi}; {n} ranks on cuda:0 ({MESH_SERVE_SHAPE} over "
        f"{MESH_SERVE_AXES}), attention strategy {strategy!r}; {split} of "
        f"{len(values)} weights split; at rest a rank holds "
        f"{', '.join(f'{b / 1e6:.1f}' for b in at_rest)} MB of "
        f"{total / 1e6:.1f} MB ({cfg.param_count() / 1e9:.3f} B "
        f"parameters), placing them peaked at {placed_peak / 1e9:.3f} GB "
        f"above the {held / 1e9:.3f} GB held; max_memory_allocated while "
        f"serving {serve_peak / 1e9:.3f} GB (phase 5's weights and the "
        f"placed copy)")
    checks["(b) every rank holds within 5% of an eighth of the "
           "weights"] = all(abs(b / (total / n) - 1) <= 0.05
                            for b in at_rest)
    checks["(b) every weight matrix is split"] = all(
        isinstance(v, Sharded) for v in values if v.ndim == 2)
    checks["(a) the same sequence ids"] = msids == sids
    steps, ties, bad, worst, limit = _compare_greedy(ref_logits, ref_toks,
                                                     watch, tag)
    checks["(c) greedy tokens equal the single-device engine's (or differ "
           "at logged near-ties)"] = bad == 0
    checks["(c) logits within SERVE_RTOL x max |logit| of the "
           "single-device engine's"] = worst <= limit
    checks["(c) at most one fused_mesh drain a round"] = all(
        ev in ([], ["fused_mesh"]) for ev, *_ in per_round)
    checks[f"(c) K2 == {L} x {n} a round"] = all(
        r[3] == L * n for r in per_round)
    blocks = mesh.axis_size("model") if strategy == "heads" else 1
    checks[f"(c) K3 == {L} x {blocks} per admission (one a block of "
           "heads)"] = all(k == L * blocks for k in k3_per)
    checks["(c) K7 and K1 ran on the path"] = \
        path.get("psm_transfer", 0) > 0 and \
        path.get("fused_dispatch", 0) > 0
    log(f"{tag} (c) admitted {PROMPT_LENS}, forked, {ROUNDS} rounds: "
        f"{steps} greedy steps, {ties} near-ties, {bad} unexcused; max "
        f"|logit diff| vs single {worst:.3e} (limit {limit:.3e}); K1 / K7 "
        f"/ K2 a round {[r[1:4] for r in per_round]}; "
        f"fused_mesh a round {[len(ev) for ev, *_ in per_round]}; K3 per "
        f"admission {k3_per}; the unplaced mesh engine's tokens "
        f"{'equal' if whole_toks == ref_toks else 'differ from'} the "
        "single engine's")
    log(f"{tag} (d) ms a round (rounds 3-{ROUNDS}, median, host clock, "
        f"synchronised), {smi}: placed {steady(placed_ms):.2f} ms, "
        f"unplaced mesh (phase 22's engine) {steady(whole_ms):.2f} ms "
        f"({steady(placed_ms) / steady(whole_ms):.2f}x), single device "
        f"{steady(one_ms):.2f} ms")
    prof = _profile_mesh_round(eng.decode_round, tag)
    checks["(d) the profile saw K2"] = prof.get("K2_ms", 0) > 0
    del eng
    torch.cuda.empty_cache()

    # (e) K3 over a block of query rows (q_offset): the last 2,048
    # rows of a 4,096 prefill at llama3.2-3b's heads
    H, KVH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    S, R = PLACED_K3_S, PLACED_K3_ROWS
    off = S - R
    gen = torch.Generator(device="cuda").manual_seed(SEED + 26)
    q, k, v = _k3_inputs(gen, 1, R, H, KVH, D, S)

    def kern():
        return ops.flash_attention(q, k, v, q_offset=off,
                                   use_kernel=True)

    c0 = _counts()
    out = kern()
    want = ops.flash_attention(q, k, v, q_offset=off, use_kernel=False)
    torch.cuda.synchronize()
    err = float((out.float() - want.float()).abs().max())
    top = float(want.float().abs().max())
    typical = float(want.float().abs().mean())
    limit_e = K3_OFFSET_RTOL * top
    # the same rows of the whole prefill through K3 at offset 0
    qf, _, _ = _k3_inputs(gen, 1, S, H, KVH, D)
    qf[:, :, off:] = q
    full = ops.flash_attention(qf, k, v, use_kernel=True)[:, :, off:]
    torch.cuda.synchronize()
    err_full = float((out.float() - full.float()).abs().max())
    ms = time_ms(kern, scrub=scrub)
    dev, _ = device_ms(kern, key="flash_kernel")
    plain_ms = time_ms(lambda: ops.flash_attention(
        q, k, v, q_offset=off, use_kernel=False), reps=3)
    cols = torch.arange(S, device="cuda")
    mask = cols[None, :] <= torch.arange(off, S, device="cuda")[:, None]
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True), scrub=scrub)
    launched = _since(c0)["flash_attention"]
    work = cost.k3_work(q, k, v, q_offset=off)
    b_ops = work.flops / cost.BF16_FLOPS * 1e3
    b_bytes = work.bytes / cost.HBM_BYTES_PER_S * 1e3
    bound = max(b_ops, b_bytes)
    log(f"{tag} (e) K3 q_offset {off}: rows {off}-{S - 1} of a {S} "
        f"prefill (B=1, H={H}, KVH={KVH}, D={D}) over {S} keys: max "
        f"|diff| vs plain {err:.3e} (limit {limit_e:.3e}: "
        f"{K3_OFFSET_RTOL} x max |plain| {top:.3e}; mean |plain| "
        f"{typical:.3e}), vs the whole prefill's rows through K3 "
        f"{err_full:.3e} (limit 0: the same tiles); kernel {ms:.4f} ms "
        f"(device only {_fmt_ms(dev)}), plain {plain_ms:.4f} ms, SDPA "
        f"with the offset mask {lib_ms:.4f} ms, bound {bound:.5f} ms "
        f"({'operations' if b_ops >= b_bytes else 'bytes'}: "
        f"{work.flops:.3e} flop, {work.bytes} bytes), {smi}")
    checks["(e) K3 with q_offset within K3_OFFSET_RTOL x max |out| of its "
           "plain version"] = err <= limit_e and launched >= 2
    checks["(e) K3 with q_offset equals the whole prefill's rows "
           "bitwise"] = err_full == 0
    del q, k, v, qf, out, want, full, mask
    torch.cuda.empty_cache()
    # (f) the dense cells walked with placed weights, a process each: they
    # start once (a)-(e) are timed and profiled, and run beside the
    # check run alone
    t_walk = time.perf_counter()
    with _walking(PLACED_DRY_CELLS) as walks:
        # every K2 / K3 call of the admissions and the first round against
        # its plain version (a check run, left out of the path)
        def tapped_path():
            tap = engine(model, mesh)
            _admit_all(tap, prompts)
            tap.decode_round()

        _, reads = tapped(tapped_path)
        torch.cuda.empty_cache()
        calls = {op: r["calls"] for op, r in reads.items()}
        checks["(c) the first round's K2 calls and the admissions' K3 calls "
               "equal their plain versions"] = \
            calls == {"flash_attention": L * blocks * len(prompts),
                      "paged_attention_slab": L * n} and \
            all(r["err"] <= r["limit"] for r in reads.values())
        log(f"{tag} (c) every kernel call vs its plain version: "
            + _fmt_reads(reads))
        del model, values
        torch.cuda.empty_cache()

        ok, failed_walks = _walked_rows(
            walks, time.perf_counter() + PLACED_DRY_TIMEOUT)
    gib = 2 ** 30
    for r in ok:
        m = r["memory"]
        r["temp_gib"] = m["temp_size_in_bytes"] / gib
        r["args_gib"] = m["argument_size_in_bytes"] / gib
        log(f"{tag} (f) {r['arch']} {r['shape']} placed over (16, 16): "
            f"{r['dominant']}-bound on rank {r['busiest_rank']}: t_compute "
            f"{r['t_compute_s'] * 1e3:.4g} / t_memory "
            f"{r['t_memory_s'] * 1e3:.4g} / t_peer "
            f"{r['t_collective_s'] * 1e3:.4g} ms; temp {r['temp_gib']:.4g}"
            f" + arguments {r['args_gib']:.4g} GiB; walk {r['compile_s']} s"
            f"; peer bytes by path {r['collectives']}")
    for w in failed_walks:
        log(f"{tag} (f) FAILED walk {w}")
    log(f"{tag} (f) {len(ok)} cells walked in "
        f"{time.perf_counter() - t_walk:.1f} s (reckoned against the "
        "published peaks, not measured)")
    checks["(f) every placed dense cell walked"] = \
        not failed_walks and len(ok) == len(PLACED_DRY_CELLS)
    checks[f"(f) every decode_32k cell's busiest rank holds under "
           f"{DECODE_ARGS_GIB:.0f} GiB of arguments"] = all(
        r["args_gib"] < DECODE_ARGS_GIB for r in ok
        if r["shape"] == "decode_32k")
    checks[f"(f) every prefill_32k cell fits {RANK_GIB} GiB on its busiest "
           "rank"] = all(r["temp_gib"] + r["args_gib"] <= RANK_GIB
                         for r in ok if r["shape"] == "prefill_32k")
    log(f"{tag} phase 26 took {time.perf_counter() - t_phase:.1f} s")
    for name, ok_ in checks.items():
        log(f"{tag} {'ok  ' if ok_ else 'FAIL'} {name}")
    failed = [k for k, ok_ in checks.items() if not ok_]
    if failed:
        raise AssertionError(f"placed serving checks failed: {failed}")
    return {"llama3.2-3b placed serve": path}


# ---------------------------------------------------------------------------
# phase 27: the moe decoder's serving weights placed over a rank mesh
# (weights.place_params; models/moe.py moe_ffn_placed: the all-to-all and
# local paths on the experts where they lie)
# ---------------------------------------------------------------------------

#: (a), (d), (f) the batched prefill: B x S, which the all-to-all over (2,
#: 4) takes (2 data groups, 4 model ranks of 128 positions)
PLACED_MOE_B, PLACED_MOE_S = 2, 512
#: (f) phi3.5-moe cut as phase 13 cuts it, its decode steps, and the
#: blocks a sequence of its state (a multiple of the 4 model ranks of a
#: batch group, so that each sequence's blocks lie in its group's slabs)
PLACED_PHI_LAYERS, PLACED_PHI_STEPS, PLACED_PHI_NPER = 8, 3, 12
#: (g) the moe decode cells walked with placed weights, and the busiest
#: rank's argument bytes and FLOPs that ``python -m
#: repro_torch.launch.dryrun`` reckons for them on a CPU
PLACED_MOE_DRY = {("deepseek-moe-16b", "decode_32k"):
                  (3_891_046_400, 129_003_421_696),
                  ("phi3.5-moe-42b-a6.6b", "decode_32k"):
                  (2_475_739_648, 332_224_528_384)}
#: (g) a moe decode cell's bound on the busiest rank's arguments (GiB)
#: and the seconds its walk may take
PLACED_MOE_ARGS_GIB, PLACED_MOE_DRY_TIMEOUT = 4.0, 300


def _slot_rows(eng, slots: dict) -> list:
    """Row j of ``eng``'s decode batch as the row (slot) the recorded
    engine held the same sequence in (``slots``: sid -> slot); -1 for a
    slot with no sequence."""
    out = [-1] * eng.cache.max_seqs
    for sid in eng.tokens:
        out[eng.cache.slot_of(sid)] = slots[sid]
    return out


def _profile_placed_round(step, tag: str) -> dict:
    """One profiled round of a placed moe engine: wall and device busy ms,
    the idle share, the device ms of the expert products (the kernels
    launched inside ``moe.placed_experts``, which also gathers each
    expert block's weights), of the joins of ``launch.mesh.take`` (the
    moves between ranks: on one card each is a concatenation), of K2 and
    of the rest, and the host gap."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import moe
    saved = moe.placed_experts

    def ranged(*args, **kw):
        with record_function("moe.experts"):
            return saved(*args, **kw)

    moe.placed_experts = ranged
    try:
        torch.cuda.synchronize()
        opening = torch.zeros(1, device="cuda")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            opening.add_(1)
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        moe.placed_experts = saved
    cuda = torch.autograd.DeviceType.CUDA
    avgs = prof.key_averages()
    # a range's device-side span carries its CPU range's name: not a kernel
    ranges = {a.key for a in avgs if a.device_type != cuda}
    rows, experts = [], 0.0
    for avg in avgs:
        if avg.key == "moe.experts":
            if avg.device_type != cuda:
                experts += getattr(avg, "device_time_total", 0.0)
            continue
        if avg.device_type != cuda or avg.key in ranges:
            continue
        dev = getattr(avg, "self_device_time_total", 0.0)
        if dev > 0:
            rows.append((dev, avg.count, avg.key))
    busy = sum(r[0] for r in rows)
    if not busy:
        log(f"{tag} (e) device time: not measured (the profiler recorded "
            "no kernel)")
        return {}

    def of(key):
        return sum(r[0] for r in rows if key in r[2]) / 1e3

    out = {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
           "idle": 1 - busy / wall_us, "experts_ms": experts / 1e3,
           "joins_ms": of("CatArrayBatchedCopy"), "K2_ms": of("paged_attn")}
    out["other_ms"] = out["busy_ms"] - out["experts_ms"] - out["K2_ms"]
    log(f"{tag} (e) one profiled round: wall {out['wall_ms']:.2f} ms, "
        f"device busy {out['busy_ms']:.2f} ms, idle share "
        f"{out['idle']:.3f}; the expert products (kernels inside "
        f"placed_experts, their weights' gathers included) "
        f"{out['experts_ms']:.3f} ms, take's joins (concatenations, in "
        f"and out of that range) {out['joins_ms']:.3f} ms, K2 "
        f"{out['K2_ms']:.3f} ms, the rest {out['other_ms']:.3f} ms, host "
        f"gap {out['wall_ms'] - out['busy_ms']:.2f} ms")
    for dev, count, key in sorted(rows, reverse=True)[:8]:
        log(f"{tag} (e)   {dev / 1e3:8.3f} ms {count:5d} calls  {key[:90]}")
    return out


def _placed_phi_leg(mesh, smi: str, checks: dict) -> None:
    """(f) phi3.5-moe cut to :data:`PLACED_PHI_LAYERS` layers at its
    published widths, seed 0: the batched prefill of the unplaced model
    over ``mesh`` (the all-to-all on whole weights) and one device's, then
    :data:`PLACED_PHI_STEPS` decode steps on one device over the mesh
    prefill's K/V; the same model placed in place over ``mesh``: its
    batched prefill (the all-to-all) and decode steps (the local path) fed
    the same tokens, held to ``SERVE_RTOL``."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.lm import _page_writer, paged_state
    from repro_torch.weights import init_params, place_params
    arch = "phi3.5-moe-42b-a6.6b"
    tag = f"[{arch} placed]"
    cfg = dataclasses.replace(get_config(arch), num_layers=PLACED_PHI_LAYERS)
    L, B, S, nper = cfg.num_layers, PLACED_MOE_B, PLACED_MOE_S, \
        PLACED_PHI_NPER
    model = init_params(cfg, seed=SEED, device="cuda")
    tokens = torch.from_numpy(np.random.default_rng(SEED + 13).integers(
        2, cfg.vocab_size, (B, S))).cuda()
    page = model.page
    routes = moe.RouteLog(cfg.num_experts)

    def run(mesh_, feed, mode="record"):
        """The prefill over ``mesh`` (placed or not), then the decode steps
        over ``mesh_`` (None: one device) from its K/V, fed ``feed``'s
        tokens where given, else its own greedy ones, under ``routes`` in
        ``mode``; the logits of every call on the host, the tokens fed,
        and the moe paths."""
        routes.reset(mode)
        moe.ROUTE_HOOK = routes
        try:
            return _steps(mesh_, feed)
        finally:
            moe.ROUTE_HOOK = None

    def _steps(mesh_, feed):
        moe.PATH_COUNTS.clear()
        logits, k, v = model.prefill(tokens, mesh=mesh)
        paths = [dict(moe.PATH_COUNTS)]
        if isinstance(k, list):
            k, v = torch.cat(k, dim=1), torch.cat(v, dim=1)
        state = paged_state(cfg, B, nper * page, page, mesh_,
                            model.act_dtype, "cuda")
        write = _page_writer(state, page, nper)
        for li in range(L):
            write(li, k[li], v[li])
        del k, v
        out, toks = [logits.cpu().numpy()], []
        seq = torch.full((B,), S, dtype=torch.int32, device="cuda")
        for step in range(PLACED_PHI_STEPS):
            tok = feed[step] if feed else logits.argmax(-1)
            moe.PATH_COUNTS.clear()
            logits = model.decode_step(
                tok, seq, state["k_pools"], state["v_pools"],
                state["block_table"], state["share_mask"], state["base"],
                mesh=mesh_)
            paths.append(dict(moe.PATH_COUNTS))
            out.append(logits.cpu().numpy())
            toks.append(tok)
            seq = seq + 1
        del state
        torch.cuda.empty_cache()
        return out, toks, paths

    one = model.prefill(tokens)[0].cpu().numpy()
    ref, feed, ref_paths = run(None, None)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    place_params(model, mesh)
    peak = torch.cuda.max_memory_allocated() - held
    got, _, paths = run(mesh, feed, "compare")
    limits = [SERVE_RTOL * float(np.abs(r).max()) for r in ref]

    def diffs(out):
        return [float(np.abs(g - r).max()) for g, r in zip(out, ref)]

    flips, choices = routes.flipped(), routes.choices
    errs = diffs(got)
    compared = ", ".join(f"{e:.3e}" for e in errs)
    if flips and any(e > x for e, x in zip(errs, limits)):
        # phase 12's rule: the placed run under the unplaced run's routes
        got, _, _ = run(mesh, feed, "replay")
        errs = diffs(got)
    del model
    torch.cuda.empty_cache()
    agree = [float(np.mean(g.argmax(-1) == r.argmax(-1)))
             for g, r in zip(got, ref)]
    one_err = float(np.abs(one - ref[0]).max())
    replayed = "" if routes.mode == "compare" else (
        "; under the unplaced run's routes "
        + ", ".join(f"{e:.3e}" for e in errs))
    log(f"{tag} {cfg.num_layers} of 32 layers (phase 13's cut), "
        f"{cfg.num_experts} experts top-{cfg.top_k}, no shared expert, "
        f"{cfg.num_heads} heads over {cfg.num_kv_heads}; placed in place "
        f"over {MESH_SERVE_SHAPE} (peak {peak / 1e9:.3f} GB above the "
        f"{held / 1e9:.3f} GB held); prefill {B} x {S} then "
        f"{PLACED_PHI_STEPS} decode steps fed the unplaced run's tokens: "
        f"max |logit diff| placed vs unplaced over the mesh {compared} "
        f"with {flips} route flips of {choices} choices{replayed} (limits "
        f"{', '.join(f'{x:.3e}' for x in limits)}), argmax agreement "
        f"{agree}; paths placed {paths}, unplaced {ref_paths}; the "
        f"unplaced mesh prefill (all-to-all) vs one device's (local path, "
        f"capacity from S) max |logit diff| {one_err:.3e} ({smi})")
    want = [{"a2a": L}] + [{"local": L}] * PLACED_PHI_STEPS
    checks[f"(f) {arch}: the placed prefill takes the all-to-all, the "
           "decode steps the local path, in every layer"] = \
        paths == want == ref_paths
    checks[f"(f) {arch}: placed logits within SERVE_RTOL x max |logit| of "
           "the unplaced mesh run's"] = all(
        e <= x for e, x in zip(errs, limits)) and all(
        np.isfinite(g).all() for g in got)


def phase_placed_moe(smi: str) -> dict:
    """Phase 27: deepseek-moe-16b's weights placed over (2, 4) ranks of the
    card (``weights.place_params`` under ``DEFAULT_RULES``: 16 experts a
    ``model`` rank, ``embed`` over ``data``) and served by
    ``ServingEngine(mesh=)``, each rank computing with the experts it
    holds, at full width and depth, against the single-device engine on
    the same weights (placed in place after it ran: two copies do not fit
    beside the pools); then phi3.5-moe cut to 8 layers, and the walks of
    both models' decode_32k cells.  Returns the launch counts of the
    placed engine's run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import fused_dispatch as fd
    from repro_torch.launch.mesh import Sharded, make_test_mesh, rank_bytes
    from repro_torch.launch.serve import ServingEngine
    from repro_torch.models import moe
    from repro_torch.sharding.rules import attn_strategy
    from repro_torch.weights import init_params, place_params
    arch = "deepseek-moe-16b"
    tag = f"[{arch} placed]"
    t_phase = time.perf_counter()
    cfg = get_config(arch)
    L = cfg.num_layers
    mesh = make_test_mesh(MESH_SERVE_SHAPE, MESH_SERVE_AXES, devices="cuda")
    n = mesh.size
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(2, cfg.vocab_size, size=k).astype(np.int32)
               for k in PROMPT_LENS]
    batch = torch.from_numpy(np.random.default_rng(SEED + 27).integers(
        2, cfg.vocab_size, (PLACED_MOE_B, PLACED_MOE_S))).cuda()
    checks, path, events = {}, {}, []
    hook = lambda n_, p_, mech: events.append(mech)
    routes = moe.RouteLog(cfg.num_experts)
    pre_routes = moe.RouteLog(cfg.num_experts)
    slots = {}

    def engine(model, m):
        return ServingEngine(cfg, model, max_seqs=MAX_SEQS,
                             max_blocks_per_seq=MAX_BLOCKS_PER_SEQ, mesh=m)

    def serve(eng, watch=None, counted=None, mapped=False):
        """Phase 12's protocol (:func:`_placed_protocol`) under ``routes``,
        each round's rows mapped through the engines' slots (``mapped``)."""
        moe.ROUTE_HOOK = routes
        try:
            return _placed_protocol(
                eng, prompts, events, watch, ref_toks, counted,
                (lambda e: routes.map_rows(_slot_rows(e, slots)))
                if mapped else None)
        finally:
            moe.ROUTE_HOOK = None

    steady = lambda xs: float(np.median(xs[2:]))

    def prefill(model, m, hook=None):
        """The batched prefill over ``m`` (under the route hook ``hook``):
        the logits on the host and the moe paths."""
        moe.PATH_COUNTS.clear()
        moe.ROUTE_HOOK = hook
        try:
            logits = model.prefill(batch, mesh=m)[0].cpu().numpy()
        finally:
            moe.ROUTE_HOOK = None
        torch.cuda.empty_cache()
        return logits, dict(moe.PATH_COUNTS)

    t0 = time.perf_counter()
    model = init_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    ref_toks = None
    fd.add_launch_hook(hook)
    try:
        # (a) the single-device engine (routes recorded), the batched
        # prefill on one device and over the mesh on the whole weights
        one = engine(model, None)
        sids, _, _, _, one_ms, ref_toks, ref_logits = serve(one)
        slots.update({s: one.cache.slot_of(s) for s in one.tokens})
        del one
        torch.cuda.empty_cache()
        one_pre, _ = prefill(model, None)
        ref_pre, ref_pre_paths = prefill(model, mesh, pre_routes)
        # (b) the same weights placed in place
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        place_params(model, mesh)
        placed_peak = torch.cuda.max_memory_allocated() - held
        values = list(model.placement.values.values())
        at_rest = rank_bytes(values, mesh)
        total = sum(at_rest)
        # (c) the placed engine, fed the single engine's tokens
        torch.cuda.reset_peak_memory_stats()
        routes.reset("compare")
        eng = engine(model, mesh)
        watch = _GreedyWatch()
        msids, k3_per, admitted, per_round, placed_ms, _, _ = serve(
            eng, watch, path, mapped=True)
        serve_peak = torch.cuda.max_memory_allocated()
        flips, choices = routes.flipped(), routes.choices
        consumed = routes.consumed()
    finally:
        fd.remove_launch_hook(hook)
    strategy = attn_strategy(cfg.num_heads, mesh)
    split3 = sum(isinstance(v, Sharded) for v in values if v.ndim == 3)
    log(f"{tag} card {smi}; {n} ranks on cuda:0 ({MESH_SERVE_SHAPE} over "
        f"{MESH_SERVE_AXES}), attention strategy {strategy!r}; "
        f"{cfg.param_count() / 1e9:.3f} B parameters ({total / 1e9:.3f} "
        f"GB) made in {t_init:.1f} s; {split3} of {3 * L} expert matrices "
        f"split; at rest a rank holds "
        f"{', '.join(f'{b / 1e9:.4f}' for b in at_rest)} GB (an eighth: "
        f"{total / n / 1e9:.4f}); placing in place peaked at "
        f"{placed_peak / 1e9:.3f} GB above the {held / 1e9:.3f} GB held; "
        f"max_memory_allocated while serving {serve_peak / 1e9:.3f} GB")
    checks["(b) every rank holds within 5% of an eighth of the "
           "weights"] = all(abs(b / (total / n) - 1) <= 0.05
                            for b in at_rest)
    checks["(b) every weight matrix is split"] = all(
        isinstance(v, Sharded) for v in values if v.ndim >= 2)
    checks["(a) the same sequence ids"] = msids == sids
    steps, ties, bad, worst, limit = _compare_greedy(ref_logits, ref_toks,
                                                     watch, tag)
    log(f"{tag} (c) admitted {PROMPT_LENS}, forked, {ROUNDS} rounds: "
        f"{steps} greedy steps, {ties} near-ties, {bad} unexcused; max "
        f"|logit diff| vs single {worst:.3e} (limit {limit:.3e}); route "
        f"flips {flips} of {choices} choices (rows matched through the "
        f"engines' slots: {consumed})")
    if worst > limit and flips:
        # phase 12's rule: the placed run again under the single engine's
        # routes, held to the same limit
        routes.reset("replay")
        fd.add_launch_hook(hook)
        try:
            replay = _GreedyWatch()
            serve(engine(model, mesh), replay, mapped=True)
        finally:
            fd.remove_launch_hook(hook)
        torch.cuda.empty_cache()
        steps, ties, bad, worst, limit = _compare_greedy(
            ref_logits, ref_toks, replay, tag + " (replayed routes)")
        log(f"{tag} (c) replayed under the single engine's routes: "
            f"{ties} near-ties, {bad} unexcused; max |logit diff| "
            f"{worst:.3e} (limit {limit:.3e})")
    checks["(c) the single engine's routes matched row by row"] = consumed
    checks["(c) greedy tokens equal the single-device engine's (or differ "
           "at logged near-ties)"] = bad == 0
    checks["(c) logits within SERVE_RTOL x max |logit| of the "
           "single-device engine's"] = worst <= limit
    checks["(c) at most one fused_mesh drain a round"] = all(
        ev in ([], ["fused_mesh"]) for ev, *_ in per_round)
    checks[f"(c) K2 == {L} x {n} a round"] = all(
        r[3] == L * n for r in per_round)
    blocks = mesh.axis_size("model") if strategy == "heads" else 1
    checks[f"(c) K3 == {L} x {blocks} per admission (one a block of "
           "heads)"] = all(k == L * blocks for k in k3_per)
    checks["(c) K7 and K1 ran on the path"] = \
        path.get("psm_transfer", 0) > 0 and \
        path.get("fused_dispatch", 0) > 0
    checks["(c) every admission's and round's moe FFN took the local "
           "path"] = admitted == {"local": L * len(PROMPT_LENS)} and all(
        r[4] == {"local": L} for r in per_round)
    log(f"{tag} (c) K1 / K7 / K2 a round "
        f"{[r[1:4] for r in per_round]}; fused_mesh a "
        f"round {[len(ev) for ev, *_ in per_round]}; K3 per admission "
        f"{k3_per}; moe paths of the admissions {admitted}, of a round "
        f"{per_round[0][4]}")

    # (d) the placed batched prefill against the unplaced one over the mesh
    pre_routes.reset("compare")
    got_pre, pre_paths = prefill(model, mesh, pre_routes)
    pre_err = float(np.abs(got_pre - ref_pre).max())
    pre_limit = SERVE_RTOL * float(np.abs(ref_pre).max())
    pre_flips = pre_routes.flipped()
    if pre_err > pre_limit and pre_flips:
        pre_routes.reset("replay")
        got_pre, _ = prefill(model, mesh, pre_routes)
        pre_err = float(np.abs(got_pre - ref_pre).max())
        log(f"{tag} (d) replayed under the unplaced prefill's routes: max "
            f"|logit diff| {pre_err:.3e}")
    log(f"{tag} (d) batched prefill {PLACED_MOE_B} x {PLACED_MOE_S}: paths "
        f"placed {pre_paths}, unplaced over the mesh {ref_pre_paths}; max "
        f"|logit diff| vs the unplaced mesh prefill {pre_err:.3e} (limit "
        f"{pre_limit:.3e}), route flips {pre_flips} of "
        f"{pre_routes.choices} choices; argmax agreement "
        f"{float(np.mean(got_pre.argmax(-1) == ref_pre.argmax(-1))):.2f}; "
        f"the unplaced mesh prefill (all-to-all) vs one device's (local "
        f"path, capacity from S) {float(np.abs(ref_pre - one_pre).max()):.3e}")
    checks[f"(d) the placed batched prefill takes the all-to-all in all "
           f"{L} layers"] = pre_paths == ref_pre_paths == {"a2a": L}
    checks["(d) its logits within SERVE_RTOL x max |logit| of the "
           "unplaced mesh prefill's"] = pre_err <= pre_limit and \
        bool(np.isfinite(got_pre).all())

    # (e) ms a round and one profiled round
    log(f"{tag} (e) ms a round (rounds 3-{ROUNDS}, median, host clock, "
        f"synchronised), {smi}: placed {steady(placed_ms):.2f} ms, single "
        f"device {steady(one_ms):.2f} ms "
        f"({steady(placed_ms) / steady(one_ms):.2f}x)")
    prof = _profile_placed_round(eng.decode_round, tag)
    checks["(e) the profile saw the expert products and K2"] = \
        prof.get("experts_ms", 0) > 0 and prof.get("K2_ms", 0) > 0
    del eng
    torch.cuda.empty_cache()

    # (g)'s walks, a process each: they start once (a)-(e) are timed and
    # profiled, and run beside the check run and (f)
    t_walk = time.perf_counter()
    with _walking(list(PLACED_MOE_DRY)) as walks:
        # every K2 / K3 call of the admissions and the first round against
        # its plain version (a check run, left out of the path)
        def tapped_path():
            tap = engine(model, mesh)
            _admit_all(tap, prompts)
            tap.decode_round()

        _, reads = tapped(tapped_path)
        calls = {op: r["calls"] for op, r in reads.items()}
        checks["(c) the first round's K2 calls and the admissions' K3 "
               "calls equal their plain versions"] = \
            calls == {"flash_attention": L * blocks * len(prompts),
                      "paged_attention_slab": L * n} and \
            all(r["err"] <= r["limit"] for r in reads.values())
        log(f"{tag} (c) every kernel call vs its plain version: "
            + _fmt_reads(reads))
        del model, values
        torch.cuda.empty_cache()
        # (f) phi3.5-moe cut to 8 layers
        _placed_phi_leg(mesh, smi, checks)
        ok, failed_walks = _walked_rows(walks,
                                        t_walk + PLACED_MOE_DRY_TIMEOUT)
    gib = 2 ** 30
    equal = []
    for r in ok:
        m = r["memory"]
        args, flops = m["argument_size_in_bytes"], r["hlo_flops_per_dev"]
        equal.append((args, flops) == PLACED_MOE_DRY[(r["arch"],
                                                      r["shape"])])
        log(f"{tag} (g) {r['arch']} {r['shape']} placed over (16, 16): "
            f"{r['dominant']}-bound on rank {r['busiest_rank']}: t_compute "
            f"{r['t_compute_s'] * 1e3:.4g} / t_memory "
            f"{r['t_memory_s'] * 1e3:.4g} / t_peer "
            f"{r['t_collective_s'] * 1e3:.4g} ms; temp "
            f"{m['temp_size_in_bytes'] / gib:.4g} + arguments "
            f"{args / gib:.4g} GiB ({args} B, {flops:.6e} FLOPs: "
            f"{'equal to' if equal[-1] else 'NOT the'} CPU walk's); walk "
            f"{r['compile_s']} s; peer bytes by path {r['collectives']}")
    for w in failed_walks:
        log(f"{tag} (g) FAILED walk {w}")
    checks["(g) both moe decode cells walked, equal to the CPU walk"] = \
        not failed_walks and len(ok) == len(PLACED_MOE_DRY) and all(equal)
    checks[f"(g) their busiest rank holds under {PLACED_MOE_ARGS_GIB:.0f} "
           f"GiB of arguments"] = all(
        r["memory"]["argument_size_in_bytes"] < PLACED_MOE_ARGS_GIB * gib
        for r in ok)
    log(f"{tag} phase 27 took {time.perf_counter() - t_phase:.1f} s")
    for name, ok_ in checks.items():
        log(f"{tag} {'ok  ' if ok_ else 'FAIL'} {name}")
    failed = [k for k, ok_ in checks.items() if not ok_]
    if failed:
        raise AssertionError(f"placed moe serving checks failed: {failed}")
    return {f"{arch} placed serve": path}


# ---------------------------------------------------------------------------
# phase 28: the facades' serving weights placed over a rank mesh (the
# Mamba2 layer of ssm and hybrid, the vlm's prefix, the encdec's encoder and
# cross-attention; the serve state placed by state_logical_axes)
# ---------------------------------------------------------------------------

#: (a)-(c) the legs: arch, mesh shape over ``MESH_SERVE_AXES`` and text
#: tokens a prompt (``PROMPT_LENS[2]``); paligemma-3b over the production
#: ``model`` size, where its 8 heads take ``"seq"`` and 256 patches + 384
#: tokens split into row blocks of 40
PLACED_FACADE_LEGS = (("mamba2-780m", MESH_SERVE_SHAPE, PROMPT_LENS[2]),
                      ("zamba2-2.7b", MESH_SERVE_SHAPE, PROMPT_LENS[2]),
                      ("paligemma-3b", (1, 16), PROMPT_LENS[2]),
                      ("seamless-m4t-medium", MESH_SERVE_SHAPE,
                       PROMPT_LENS[2]))
PLACED_FACADE_B, PLACED_FACADE_STEPS = 2, 8
#: (d) the families whose engine admits placed
PLACED_FACADE_ENGINES = ("zamba2-2.7b", "seamless-m4t-medium")
#: (e) the CPU walk's (arguments bytes, FLOPs) on the busiest rank of each
#: facade decode_32k cell over (16, 16) (``python -m
#: repro_torch.launch.dryrun``); seconds the walks may take
PLACED_FACADE_DRY = {
    ("mamba2-780m", "decode_32k"): (45054528, 798867456.0),
    ("zamba2-2.7b", "decode_32k"): (1567465064, 4706536448.0),
    ("paligemma-3b", "decode_32k"): (322658304, 4924637184.0),
    ("seamless-m4t-medium", "decode_32k"): (4035236864, 4515430400.0)}
PLACED_FACADE_DRY_TIMEOUT = 300


class _CallLog:
    """Wraps the ``kernels/ops.py`` entry ``op`` while on: keeps the
    arguments of the first call ``pick(args, kw)`` accepts (without its
    ``use_kernel``)."""

    def __init__(self, op: str, pick):
        from repro_torch.kernels import ops
        self.ops, self.op, self.pick = ops, op, pick
        self.saved, self.call = getattr(ops, op), None

    def __enter__(self):
        def call(*args, **kw):
            if self.call is None and self.pick(args, kw):
                self.call = (args, {k: v for k, v in kw.items()
                                    if k != "use_kernel"})
            return self.saved(*args, **kw)
        setattr(self.ops, self.op, call)
        return self

    def __exit__(self, *exc):
        setattr(self.ops, self.op, self.saved)


class _LayerReplay:
    """Phase 12's replay for a random Mamba2 stack: its rounding drift, not
    a route, is what a reordered sum perturbs (a K4 in float64 reads 0.92
    of ``SERVE_RTOL``'s limit, ROADMAP §3).  ``record()`` keeps each
    Mamba2 layer's input x of a run through the unplaced layers, in call
    order (``models/lm.py`` ``mamba2_layer`` / ``mamba2_decode_step``);
    ``replay()`` feeds them, in the same order, to the placed layers of
    another run (``mamba2_layer_placed`` / ``mamba2_decode_step_placed``,
    each block taken from the recorded whole), so that each layer and the
    shared blocks after it start from the first run's input."""

    NAMES = {"record": ("mamba2_layer", "mamba2_decode_step"),
             "replay": ("mamba2_layer_placed", "mamba2_decode_step_placed")}

    def __init__(self):
        self.inputs, self.mode, self.fed = [], None, 0

    def record(self):
        self.mode, self.inputs = "record", []
        return self

    def replay(self):
        self.mode, self.fed = "replay", 0
        return self

    def __enter__(self):
        from repro_torch.launch.mesh import map_blocks
        from repro_torch.models import lm
        self.lm = lm
        self.saved = {n: getattr(lm, n) for n in self.NAMES[self.mode]}

        def recorded(fn):
            def call(layer, x, *args, **kw):
                self.inputs.append(x.clone())
                return fn(layer, x, *args, **kw)
            return call

        def replayed(fn):
            def call(layer, x, *args, **kw):
                src = self.inputs[self.fed].reshape(x.shape)
                self.fed += 1
                x = map_blocks(x.sharding, x.shape, lambda b, sl, r: src[sl]
                               .to(x.dtype).clone())
                return fn(layer, x, *args, **kw)
            return call

        wrap = recorded if self.mode == "record" else replayed
        for n, fn in self.saved.items():
            setattr(lm, n, wrap(fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.lm, n, fn)


def _timed_call(op: str, call, key: str, smi: str, tag: str) -> None:
    """The recorded call of ``op`` through its kernel: card and device-only
    ms, its plain version's ms, the bound of ``kernels/cost.py`` and, for
    K3, SDPA over the same mask (a yardstick: the port never calls it),
    each logged with the card."""
    import torch.nn.functional as F
    from repro_torch.kernels import cost, ops
    args, kw = call
    fn = getattr(ops, op)
    ms = time_ms(lambda: fn(*args, use_kernel=True, **kw))
    dev, _ = device_ms(lambda: fn(*args, use_kernel=True, **kw), key=key)
    plain = time_ms(lambda: fn(*args, use_kernel=False, **kw), reps=3)
    lib = "none"
    if op == "flash_attention":
        q, k, v = args
        mask = None
        if kw.get("causal", True):
            rows = torch.arange(q.shape[2], device=q.device)[:, None]
            cols = torch.arange(k.shape[2], device=q.device)[None, :]
            mask = (cols <= rows + kw.get("q_offset", 0)) | \
                (cols < kw.get("prefix_len", 0))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True))
        lib = f"SDPA {lib_ms:.4f} ms"
    work = cost.k3_work(*args, **kw) if op == "flash_attention" \
        else cost.k4_work(*args)
    b_ops = work.flops / cost.BF16_FLOPS * 1e3
    b_bytes = work.bytes / cost.HBM_BYTES_PER_S * 1e3
    shapes = ", ".join(str(tuple(a.shape)) for a in args)
    log(f"{tag} {op} at {shapes} {kw}: kernel {ms:.4f} ms (device only "
        f"{_fmt_ms(dev)}), plain {plain:.4f} ms, library {lib}, bound "
        f"{max(b_ops, b_bytes):.5f} ms "
        f"({'operations' if b_ops >= b_bytes else 'bytes'}: "
        f"{work.flops:.3e} flop, {work.bytes} bytes), {smi}")


def _expected_launches(cfg, mesh, B: int, S: int) -> tuple:
    """(K4, K3 of a prefill; K2, K3 of a decode step) of a placed facade
    over ``mesh``: K4 once a Mamba2 layer and head block, K3 once an
    attention layer and q block (the encoder's over its frames, the
    cross-attention's as the self-attention's), K2 once a layer and slab,
    an encdec step's K3 once a layer and batch block."""
    from repro_torch.launch.mesh import Sharding
    from repro_torch.models.attention import placed_qkv_shardings
    from repro_torch.models.mamba2 import ssm_layouts
    from repro_torch.sharding.rules import attn_strategy, logical_to_spec
    fam, L = cfg.family, cfg.num_layers
    if fam in ("ssm", "hybrid"):
        k4 = L * len(ssm_layouts(mesh, B, S, cfg)[0].owners())
    else:
        k4 = 0
    k3 = 0
    if cfg.num_attn_layers:
        strategy = "heads" if fam == "hybrid" else \
            attn_strategy(cfg.num_heads, mesh)

        def blocks(n):
            return len(placed_qkv_shardings(mesh, strategy, B, n,
                                            cfg.num_heads,
                                            cfg.num_kv_heads)[0].owners())
        k3 = cfg.num_attn_layers * blocks(S)
        if fam == "encdec":
            k3 += L * blocks(S) + cfg.encoder_layers * blocks(
                max(S // cfg.src_frames_ratio, 1))
    groups = len(Sharding(mesh, logical_to_spec(("batch",), mesh,
                                                dims=(B,))).owners())
    return (k4, k3, cfg.num_attn_layers * mesh.size,
            L * groups if fam == "encdec" else 0)


def _placed_facade_leg(arch: str, shape, text: int, smi: str,
                       checks: dict) -> dict:
    """(a)-(c) one leg: the single-device facade, then the same weights
    placed in place over ``shape`` fed its tokens.  Returns the placed
    run's launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh, rank_bytes
    from repro_torch.weights import init_params, place_params
    cfg = get_config(arch)
    tag = f"[{arch} placed facade]"
    mesh = make_test_mesh(shape, MESH_SERVE_AXES, devices="cuda")
    n, B, steps = mesh.size, PLACED_FACADE_B, PLACED_FACADE_STEPS
    model = init_params(cfg, seed=SEED, device="cuda")
    tokens, extra = _facade_inputs(cfg, np.random.default_rng(SEED), B,
                                   text)
    S = text + (cfg.vision_tokens if cfg.family == "vlm" else 0)
    page = model.page
    # decode room: B x nper blocks a multiple of the ranks (the
    # reference's shard_map condition)
    nper = -(-(S + steps) // page)
    while (B * nper) % n:
        nper += 1
    margin = nper * page - S

    def run(m, feed):
        """The prefill and ``steps`` greedy steps over ``m`` (None: one
        device), fed ``feed``'s tokens where given: logits, tokens, the
        prefill's ms and launches, each step's ms and launches."""
        torch.cuda.synchronize()
        c0, t = _counts(), time.perf_counter()
        logits, state = model.prefill_state(tokens, margin_tokens=margin,
                                            mesh=m, **extra)
        torch.cuda.synchronize()
        pre_ms, pre = (time.perf_counter() - t) * 1e3, _since(c0)
        out, toks, ms, per = [logits], [], [], []
        for i in range(steps):
            toks.append(feed[i] if feed else out[-1].argmax(-1))
            c1, t = _counts(), time.perf_counter()
            logits, state = model.decode_state(state, toks[-1], mesh=m)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            per.append(_since(c1))
            out.append(logits)
        return out, toks, pre_ms, pre, ms, per, state

    mamba = cfg.family in ("ssm", "hybrid")
    layers = _LayerReplay()
    with (layers.record() if mamba else contextlib.nullcontext()):
        ref, toks, one_pre_ms, _, one_ms, _, state = run(None, None)
    del state
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    place_params(model, mesh)
    peak = torch.cuda.max_memory_allocated() - held
    at_rest = rank_bytes(list(model.placement.values.values()), mesh)
    total = sum(at_rest)
    log(f"{tag} {n} ranks on cuda:0 ({shape} over {MESH_SERVE_AXES}), "
        f"{cfg.param_count() / 1e9:.3f} B parameters ({total / 1e9:.3f} "
        f"GB); at rest a rank holds "
        f"{', '.join(f'{b / 1e9:.4f}' for b in at_rest)} GB (1/{n}: "
        f"{total / n / 1e9:.4f}); placing in place peaked at "
        f"{peak / 1e9:.3f} GB above the {held / 1e9:.3f} GB held")
    c_all = _counts()
    got, _, pre_ms, pre, ms, per, state = run(mesh, toks)
    path = _since(c_all)
    k4, k3, k2, k3_step = _expected_launches(cfg, mesh, B, S)
    checks[f"{arch}: prefill K4 == {k4}, K3 == {k3}, no K2"] = \
        pre["ssd_intra_chunk"] == k4 and pre["flash_attention"] == k3 and \
        pre["paged_attention"] == 0
    checks[f"{arch}: a step K2 == {k2}, K3 == {k3_step}"] = all(
        p["paged_attention"] == k2 and p["flash_attention"] == k3_step
        and p["ssd_intra_chunk"] == 0 for p in per)
    limit = max(SERVE_RTOL * float(b.abs().max()) for b in ref)
    errs = [float((a - b).abs().max()) for a, b in zip(got, ref)]
    worst, replayed, ties, bad, flips = max(errs), None, 0, 0, []
    if mamba and worst > limit:
        # the placed run again with every Mamba2 layer fed one device's
        # input (phase 12's rule: the drift, not the layers, is replayed)
        with layers.replay():
            replayed = [float((a - b).abs().max()) for a, b in zip(
                run(mesh, toks)[0], ref)]
        torch.cuda.empty_cache()
    for step, (a, b) in enumerate(zip(got, ref)):
        for s in (a.argmax(-1) != b.argmax(-1)).nonzero()[:, 0].tolist():
            margin_ = _top2(b[s].float().cpu().numpy())
            d = float((a[s] - b[s]).abs().max())
            flips.append((step, s, margin_))
            if margin_ <= 2 * d:
                ties += 1
                log(f"{tag} near-tie at seed {SEED}, step {step}, sequence "
                    f"{s}: margin {margin_:.3e} <= 2 x |logit diff| "
                    f"{d:.3e}")
            else:
                bad += 1
    checks[f"{arch}: logits within SERVE_RTOL x max |logit| of one "
           "device's (with each Mamba2 layer fed one device's input where "
           "the free run drifts past it)"] = \
        max(replayed or errs) <= limit and all(
            bool(torch.isfinite(g).all()) for g in got)
    checks[f"{arch}: greedy tokens equal one device's but at near-ties"] = \
        bad == 0
    med = lambda xs: float(np.median(xs[1:]))
    log(f"{tag} B={B} x {S} positions (margin {margin}), {steps} steps fed "
        f"one device's tokens: prefill K4 {pre['ssd_intra_chunk']} K3 "
        f"{pre['flash_attention']}; a step K2 "
        f"{sorted({p['paged_attention'] for p in per})} K3 "
        f"{sorted({p['flash_attention'] for p in per})}; max |logit diff| "
        f"by call {', '.join(f'{e:.3e}' for e in errs)} (limit "
        f"{limit:.3e}, {worst / limit:.2f} of it)"
        + ("" if replayed is None else
           f"; each Mamba2 layer fed one device's input: "
           f"{', '.join(f'{e:.3e}' for e in replayed)} "
           f"({max(replayed) / limit:.2f} of the limit)")
        + f"; argmax mismatches (step, sequence, margin) {flips or 'none'}, "
        f"{ties} near-ties, {bad} unexcused")
    log(f"{tag} ms (host clock, synchronised), {smi}: prefill placed "
        f"{pre_ms:.1f}, one device {one_pre_ms:.1f} "
        f"({pre_ms / one_pre_ms:.2f}x); a step (steps 2-{steps}, median) "
        f"placed {med(ms):.2f}, one device {med(one_ms):.2f} "
        f"({med(ms) / med(one_ms):.2f}x)")
    tok = toks[-1]
    _profile_mesh_round(lambda: model.decode_state(state, tok, mesh=mesh),
                        tag, "(step)")
    del state, got, ref
    torch.cuda.empty_cache()

    # every K2 / K3 / K4 call of the prefill and the first step against its
    # plain version (a check run, left out of the path), keeping one K3
    # call (the row block across the vlm's prefix end, else the first) and
    # the first K4 call to time
    def taps():
        _, st = model.prefill_state(tokens, margin_tokens=margin,
                                    mesh=mesh, **extra)
        model.decode_state(st, toks[0], mesh=mesh)

    prefix = cfg.vision_tokens if cfg.family == "vlm" else 0
    with _CallLog("flash_attention", lambda a, kw: not prefix or (
            kw.get("q_offset", 0) < prefix < kw.get("q_offset", 0)
            + a[0].shape[2])) as k3_log, \
            _CallLog("ssd_intra_chunk", lambda a, kw: True) as k4_log:
        _, reads = tapped(taps)
    want = {"ssd_intra_chunk": k4, "flash_attention": k3 + k3_step,
            "paged_attention_slab": k2}
    checks[f"{arch}: every K2 / K3 / K4 call of the prefill and the first "
           "step equals its plain version"] = \
        {op: r["calls"] for op, r in reads.items()} == \
        {op: c for op, c in want.items() if c} and \
        all(r["err"] <= r["limit"] for r in reads.values())
    log(f"{tag} every kernel call vs its plain version (one launch a "
        f"call): " + _fmt_reads(reads))
    for op, lg, key in (("flash_attention", k3_log, "flash_kernel"),
                        ("ssd_intra_chunk", k4_log, "ssd_intra")):
        if lg.call is not None:
            _timed_call(op, lg.call, key, smi, tag)
    del model, k3_log, k4_log
    torch.cuda.empty_cache()
    return path


def _facade_admissions(cfg, model, mesh, prompts, events) -> tuple:
    """(d) ``prompts`` admitted by ``ServingEngine(mesh=)`` and its
    admission rounds drained: per admission the blocks, logits and
    per-sequence state on the host, the pools' promoted blocks, and the
    drains of each round."""
    from repro_torch.launch.serve import ServingEngine
    eng = ServingEngine(cfg, model, max_seqs=MAX_SEQS,
                        max_blocks_per_seq=MAX_BLOCKS_PER_SEQ, mesh=mesh)
    drains, out = [], {}
    for p in prompts:
        sid = eng.add_request(p)
        e0 = len(events)
        eng.stream.flush()
        eng._post_flush()
        drains.append(events[e0:])
        blocks = list(eng.cache.seqs[sid].blocks)
        out[sid] = dict(blocks=blocks, logits=eng.last_logits[sid].copy(),
                        extras={k: t.float().cpu() for k, t in
                                eng._extras.get(sid, {}).items()},
                        pages={name: eng.engine.pools[name][:, blocks]
                               .float().cpu() for name in ("k", "v")})
    del eng
    torch.cuda.empty_cache()
    return out, drains


def _admitted_alike(placed: dict, whole: dict) -> tuple:
    """(same ids, blocks and state keys; max |diff| and max |value| of
    the logits, pages and per-sequence state) of two
    :func:`_facade_admissions`."""
    worst = {"logits": 0.0, "pages": 0.0, "extras": 0.0}
    scale = dict(worst)
    same = list(placed) == list(whole)
    for sid, w in whole.items():
        g = placed.get(sid, w)
        same &= g["blocks"] == w["blocks"] and \
            set(g["extras"]) == set(w["extras"])
        pairs = [("logits", g["logits"], w["logits"])] + \
            [("pages", g["pages"][k], w["pages"][k]) for k in w["pages"]] + \
            [("extras", g["extras"][k], w["extras"][k]) for k in w["extras"]
             if k in g["extras"]]
        for key, a, b in pairs:
            a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
            worst[key] = max(worst[key], float(np.abs(a - b).max()))
            scale[key] = max(scale[key], float(np.abs(b).max()))
    return same, worst, scale


def phase_placed_facades(smi: str) -> dict:
    """Phase 28: the facades' weights placed over ranks of the card and
    served through ``prefill_state`` / ``decode_state(mesh=)`` and
    ``ServingEngine(mesh=)`` admission, each rank computing with the blocks
    it holds, against one device (or the unplaced mesh engine) on the same
    weights.  Returns the launch counts of each placed leg's run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import fused_dispatch as fd
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.weights import init_params, place_params
    t_phase = time.perf_counter()
    checks, paths, events = {}, {}, []
    hook = lambda n_, p_, mech: events.append(mech)
    mesh = make_test_mesh(MESH_SERVE_SHAPE, MESH_SERVE_AXES, devices="cuda")
    # (e)'s walks, a process each, run beside the legs (the phase keeps
    # within its time; a leg's ms are reported, not judged)
    with _walking(list(PLACED_FACADE_DRY)) as walks:
        for arch, shape, text in PLACED_FACADE_LEGS:
            paths[f"{arch} placed facade"] = _placed_facade_leg(
                arch, shape, text, smi, checks)
        log(f"[placed facades] (a)-(c) took "
            f"{time.perf_counter() - t_phase:.1f} s")
        for arch in PLACED_FACADE_ENGINES:
            tag = f"[{arch} placed facade]"
            cfg = get_config(arch)
            rng = np.random.default_rng(SEED)
            prompts = [rng.integers(2, cfg.vocab_size, size=k).astype(
                np.int32) for k in PROMPT_LENS]
            model = init_params(cfg, seed=SEED, device="cuda")
            layers = _LayerReplay()
            fd.add_launch_hook(hook)
            try:
                with (layers.record() if cfg.family == "hybrid"
                      else contextlib.nullcontext()):
                    whole, _ = _facade_admissions(cfg, model, mesh, prompts,
                                                  events)
                place_params(model, mesh)
                c0 = _counts()
                placed, drains = _facade_admissions(cfg, model, mesh,
                                                    prompts, events)
                ran = _since(c0)
                same, worst, scale = _admitted_alike(placed, whole)
                replayed = None
                if cfg.family == "hybrid" and any(
                        worst[k] > SERVE_RTOL * scale[k] for k in worst):
                    # (a)'s rule: each Mamba2 layer fed the unplaced
                    # engine's input
                    with layers.replay():
                        again, _ = _facade_admissions(cfg, model, mesh,
                                                      prompts, events)
                    replayed = _admitted_alike(again, whole)[1]
            finally:
                fd.remove_launch_hook(hook)
            del model, layers
            torch.cuda.empty_cache()
            paths[f"{arch} placed admission"] = ran
            judged = replayed or worst
            log(f"{tag} (d) ServingEngine(mesh={MESH_SERVE_SHAPE}) admits "
                f"{PROMPT_LENS} placed against unplaced: same ids and "
                f"blocks {same}; max |diff| (max |unplaced|) " + ", ".join(
                    f"{k} {worst[k]:.3e} ({scale[k]:.3e})" for k in worst)
                + ("" if replayed is None else "; each Mamba2 layer fed "
                   "the unplaced engine's input: " + ", ".join(
                       f"{k} {replayed[k]:.3e}" for k in replayed))
                + f"; drains a round {[len(d) for d in drains]}; launches "
                f"{ {k: v for k, v in ran.items() if v} }")
            checks[f"(d) {arch}: the placed engine admits like the unplaced "
                   "mesh engine (ids, blocks, logits, staged pages and "
                   "state within SERVE_RTOL x max |value|)"] = same and all(
                judged[k] <= SERVE_RTOL * scale[k] for k in judged)
            checks[f"(d) {arch}: at most one fused_mesh drain a round"] = \
                all(d in ([], ["fused_mesh"]) for d in drains)
        ok, failed_walks = _walked_rows(walks,
                                        t_phase + PLACED_FACADE_DRY_TIMEOUT)
    gib = 2 ** 30
    equal = []
    for r in ok:
        m = r["memory"]
        args, flops = m["argument_size_in_bytes"], r["hlo_flops_per_dev"]
        equal.append((args, flops) == PLACED_FACADE_DRY[(r["arch"],
                                                         r["shape"])])
        log(f"[placed facades] (e) {r['arch']} {r['shape']} placed over "
            f"(16, 16): {r['dominant']}-bound on rank {r['busiest_rank']}: "
            f"temp {m['temp_size_in_bytes'] / gib:.4g} + arguments "
            f"{args / gib:.4g} GiB ({args} B, {flops:.6e} FLOPs: "
            f"{'equal to' if equal[-1] else 'NOT the'} CPU walk's); walk "
            f"{r['compile_s']} s; peer bytes by path {r['collectives']}")
    for w in failed_walks:
        log(f"[placed facades] (e) FAILED walk {w}")
    checks["(e) the four facade decode_32k cells walked, equal to the CPU "
           "walk"] = not failed_walks and len(ok) == len(
        PLACED_FACADE_DRY) and all(equal)
    log(f"[placed facades] phase 28 took {time.perf_counter() - t_phase:.1f}"
        " s")
    for name, ok_ in checks.items():
        log(f"[placed facades] {'ok  ' if ok_ else 'FAIL'} {name}")
    failed = [k for k, ok_ in checks.items() if not ok_]
    if failed:
        raise AssertionError(f"placed facade checks failed: {failed}")
    return paths


PHASE_NEEDS = {7: (6,), 8: (5, 6), 15: (5,), 17: (5,), 18: (5,), 19: (5,),
               21: (), 22: (5,), 23: (), 24: (21,), 25: (),
               26: (5,), 27: (), 28: ()}


def _selected(spec) -> set:
    """The phases to run for ``--phases`` (all of 2-28 by default), with
    what they need; phase 1 always runs."""
    if spec is None:
        return set(range(2, 29))
    chosen = {int(x) for x in spec.split(",") if x.strip()}
    for n in list(chosen):
        chosen.update(PHASE_NEEDS.get(n, ()))
    return chosen


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=None,
                    help="comma list of the phases to run, with those they "
                         "need (phase 1 always runs; default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    run = _selected(args.phases)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device()
    scrub = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    # each kernel's JSON row, by name; phase 9's other shapes merge into it
    rows = {}

    def merge(row):
        if row["name"] in rows:
            held = rows[row["name"]]
            held["max_abs_err"] = max(held["max_abs_err"],
                                      row["max_abs_err"])
        else:
            rows[row["name"]] = row

    for n, phase in ((2, phase_k1), (3, phase_k2), (4, phase_k3)):
        if n in run:
            merge(phase(scrub))
    torch.cuda.empty_cache()
    # launch counts of each main-path run, by path
    paths = {}
    params = None
    if 5 in run:
        paths["llama3.2-3b serve"], params = phase_decoder_serve(
            "llama3.2-3b", profile=True)
        torch.cuda.empty_cache()
    if 15 in run:
        paths["llama3.2-3b serving features"] = phase_serving_features(
            params, smi)
        torch.cuda.empty_cache()
    if 6 in run:
        copy_kernels, flat = phase_copy_kernels(scrub)
        for row in copy_kernels:
            merge(row)
        torch.cuda.empty_cache()
        if 7 in run:
            paths["fan-out drain (A/B)"], paths["fused drain (A/B)"] = \
                phase_ab(flat, scrub)
        if 8 in run:
            phase_table1(flat)
        del flat
        torch.cuda.empty_cache()
    if 8 in run:
        paths["Fig. 2"] = phase_fig2(params.cfg, params)
    if 17 in run:
        paths.update(phase_traffic(params, smi))
        torch.cuda.empty_cache()
    if 18 in run:
        paths.update(phase_recovery(params, smi))
        torch.cuda.empty_cache()
    if 19 in run:
        paths.update(phase_observability(params, smi))
        torch.cuda.empty_cache()
    if 20 in run:
        k7_row, mesh_paths = phase_mesh(scrub, smi)
        merge(k7_row)
        paths.update(mesh_paths)
        torch.cuda.empty_cache()
    if 22 in run:
        paths.update(phase_mesh_serve(params, smi))
        torch.cuda.empty_cache()
    if 26 in run:
        paths.update(phase_placed_serve(params, smi, scrub))
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    if 9 in run:
        merge(phase_k4(scrub))
        # K2 and K3 at zamba2's shared-attention shapes (head dim 80): phase
        # 11's decode batch, its batch prefill and its ragged prefill
        merge(phase_k2(scrub, B=SSM_BATCH, H=32, KVH=32, D=80))
        merge(phase_k3(scrub, H=32, KVH=32, D=80,
                       cases=((SSM_BATCH, SSM_PROMPT), (1, SSM_RAGGED),
                              (1, 512))))
        # K2 and K3 at the served configs' head groups (head dim 128):
        # yi-6b's 32 heads over 4 KV heads (group 8) and deepseek-moe-16b's
        # 16 over 16
        for H, KVH in ((32, 4), (16, 16)):
            merge(phase_k2(scrub, H=H, KVH=KVH))
            merge(phase_k3(scrub, H=H, KVH=KVH))
        # K2 and K3 at paligemma-3b's head dim 256 (8 heads over 1 KV
        # head): K2 on the serving slab, K3 at phase 14's batch prefill and
        # at S = 512 and a ragged 313, each with the 256-patch prefix and
        # without
        merge(phase_k2(scrub, H=8, KVH=1, D=256))
        merge(phase_k3(scrub, H=8, KVH=1, D=256, cases=K3_CASES_256,
                       edges=K3_EDGES_256, timed=5))
        # K2 and K3 at seamless-m4t-medium's head dim 64 (16 heads over 16
        # KV heads): K2 at phase 16's decode batch and at 8 sequences, K3
        # at phase 16's self-, encoder and cross-attention shapes
        for B in (ENC_BATCH, MAX_SEQS):
            merge(phase_k2(scrub, B=B, H=16, KVH=16, D=64))
        merge(phase_k3(scrub, H=16, KVH=16, D=64, cases=K3_CASES_64,
                       edges=(), timed=7))
    del scrub
    torch.cuda.empty_cache()
    for n, arch in ((10, "mamba2-780m"), (11, "zamba2-2.7b")):
        if n in run:
            paths[arch] = phase_mamba_model(arch)
    if 12 in run:
        # each model is dropped with the returned tuple before the next is
        # built
        paths["deepseek-moe-16b serve"] = phase_decoder_serve(
            "deepseek-moe-16b", profile=True)[0]
        torch.cuda.empty_cache()
    if 13 in run:
        for arch, layers in OTHER_CONFIGS:
            name = arch if layers is None else f"{arch} ({layers} layers)"
            paths[f"{name} serve"] = phase_decoder_serve(
                arch, layers, SHORT_PROMPT_LENS, SHORT_ROUNDS)[0]
            torch.cuda.empty_cache()
    if 14 in run:
        paths["paligemma-3b"] = phase_vlm()
    if 16 in run:
        from repro_torch.configs import get_config
        from repro_torch.weights import init_params
        paths["seamless-m4t-medium"], model = phase_encdec()
        paths["seamless-m4t-medium admission"] = phase_admission(model)
        del model
        torch.cuda.empty_cache()
        model = init_params(get_config("zamba2-2.7b"), seed=SEED,
                            device="cuda")
        paths["zamba2-2.7b admission"] = phase_admission(model)
        del model
        torch.cuda.empty_cache()
    if 23 in run:
        paths.update(phase_mesh_model(smi))
        torch.cuda.empty_cache()
    if 27 in run:
        # every earlier model freed: deepseek-moe-16b is placed in place
        paths.update(phase_placed_moe(smi))
        torch.cuda.empty_cache()
    if 28 in run:
        paths.update(phase_placed_facades(smi))
        torch.cuda.empty_cache()
    if 21 in run:
        # every earlier model is freed: the 3.2B model's fp32 training
        # state needs most of the card
        single = phase_train(smi)
        torch.cuda.empty_cache()
        if 24 in run:
            phase_mesh_train(smi, single)
            torch.cuda.empty_cache()
    if 25 in run:
        # last, on a card no earlier phase holds
        phase_dryrun(smi)
        torch.cuda.empty_cache()
    kernels = [rows[n] for n in ("fused_dispatch", "paged_attention",
                                 "flash_attention", "fpm_copy",
                                 "fpm_copy_cross", "zero_init",
                                 "ssd_intra_chunk", "psm_transfer")
               if n in rows]
    for k in kernels:
        k["route"] = "cuda"
        k["launches_by_path"] = {p: c[k["name"]] for p, c in paths.items()
                                 if c.get(k["name"])}
        k["launches"] = sum(k["launches_by_path"].values())
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "ms", "device_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row.get(k) for k in keys}
                                  for row in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
