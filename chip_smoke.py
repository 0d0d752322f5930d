#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from ``src/repro_torch/csrc`` (one
``nvcc`` per source, all started together), then runs these phases and
prints one JSON line for each:

  kernel  K2 (``event_topk``) against its plain version on the card, bit
          for bit (values and indices, idle slots included), at fleet sizes
          16384 .. 2^20 with k from 8 to 16384, k = n, and the edge cases
          (all ties, all idle, fewer pending events than k, signed zeros);
          one counted call and one planned launch a case; the pop of
          ``fl_async --clients 65536 --k 2048`` against the plain pop; a
          CUDA-graph replay of one call bitwise equal to the eager call;
          its time (CUDA events, launch overhead included, and device-only:
          ``device_ms``), the plain version's, the ``torch.topk``
          yardstick's, its bound and an empty kernel's device time; and the
          timing ladder TOPK_LADDER beside ``torch.topk``.
  main    the driver's own path, ``repro_torch.launch.fl_async`` at the
          paper CNN's full widths on MNIST at its real size (60 000 images)
          over a 16 384-client fleet with a 256-update buffer, 20 steps:
          the K2 launch count of that run, device placement of the whole
          engine state, finite losses, E[X] against n/k, steps/s and peak
          device memory; then two steps under CUDA's sync debug mode (no
          step may synchronize with the host), a steady-state timing and
          a short profiler window of the same loop.
  parity  a small replayed run (48 clients, 6 steps, draws from a fixed
          numpy seed) three ways — K2 kernel and plain K2 on the card, plain
          on the CPU — with TF32 off: discrete outputs must be equal, params
          close.
  kernel_k1    K1 (``fedavg_reduce``) against its plain version on the card
          at the sync main path's shapes (30 cohort slots, each of the paper
          CNN's eight leaves), the fleet width (320 x the fc1 leaf) and the
          edge cases (C = 1, N not a multiple of 4, all-zero weights, an
          unaligned pointer, C above the staged-weight chunk); one sync
          round's eight leaves as one grouped launch (``fedavg_reduce_leaves``)
          bitwise equal to single-leaf launches; the round's time as one
          grouped launch against eight single-leaf launches and eight
          ``torch.mv`` calls (the yardstick), per-leaf rows as for K2.
  sync_main    the sync driver's own path, ``repro_torch.launch.fl_train``
          at the paper's Sec. IV settings (100 clients, k = 15, m = 10,
          E = 5, B = 50) on MNIST at its real size, 60 rounds, with lr 0.02:
          on the synthetic MNIST stand-in the paper's lr 0.1 diverges in
          the first local steps, in the reference as in the port. K1
          launched once a round (one grouped launch for the eight param
          leaves), device placement, finite
          losses, accuracy rising, E[X] against n/k, Var[X] below random
          selection's; no host sync in two rounds; rounds/s, steady ms per
          round, device-busy share and peak memory.
  sync_parity  a small replayed sync run (48 clients, 6 rounds) with K1 on
          the card and plain on the CPU, TF32 off, each card round started
          from the CPU's params of the round before: discrete outputs
          equal, params close, K1 launched once a round.
  fault_contracts  slice C's bitwise contracts on a 48-client fleet with
          the paper CNN at full widths, cuDNN deterministic inside the
          check (restored after): every engine fault armed at rate 0 equals
          the calm run (sync: dropout, corrupt, sign_flip, scale_attack over
          4 rounds; async: all six engine faults and a deadline that never
          fires, over 4 steps: send masks, losses, params); armed at rate
          0.5, ``run_chunk`` equals per-step steps (the whole state); a
          crash after 3 steps, ``save_checkpoint``/``load_checkpoint`` of
          the state and the random streams, 3 more steps on a fresh engine
          equal 6 uninterrupted; one ``ReplayDraws`` run of the armed async
          engine whose discrete outputs (pops, ages, fault ``prone``/
          ``injected``/``exposed``, re-dispatch state, counters) equal the
          CPU port's on the same fed arrays.
  sync_attack  ``benchmarks/bench_faults.py`` part (b) at the paper CNN's
          widths and ``sync_main``'s settings, SYNC_ATTACK_ROUNDS rounds: a
          model-replacement attack (scale_attack x -3 on 25% of slots)
          under fedavg, trimmed_mean (trim 0.35) and coordinate_median;
          rounds/s, steady ms a round, eval loss and accuracy, injections,
          K1 launches (one a round for fedavg, none for the order
          statistics) and peak memory. Both robust aggregators must end
          finite and below fedavg's eval loss.
  async_chaos  ``main``'s configuration with ``--faults
          dropout,corrupt,straggler,stale_replay --fault-rate 0.1
          --robust-agg norm_clip`` and a re-dispatch deadline of
          DEADLINE_STEPS steps of ``main``'s simulated clock, 10 steps: K2
          and K1 (``norm_clip``'s clipped delta sum) one launch a step,
          every injection counter and the deadline's ``rd_expired``/
          ``redispatched`` above zero, a finite eval loss, no host sync in
          two steps; the steady ms a step beside ``main``'s as a ratio
          (``bench_faults.py`` part (a)), device-busy share and peak
          memory; then ``trimmed_mean`` and ``coordinate_median``
          (accumulate plus finalize) timed on (256, paper CNN) and (30,
          paper CNN) f32 stacks beside the bytes bound of one read.
  topo_contracts  slice D's bitwise contracts on ``fault_contracts``'
          fleet under hierarchical (4, 2) with a 5 s heartbeat: a star
          equals no topology (sync and async), tiered ``run_chunk`` equals
          per-step steps, crash-restart under the hierarchy, a replayed
          tiered run equal to the CPU's.
  async_hier  ``main`` under ``--topology hierarchical --tiers 64,8`` and a
          heartbeat of DEADLINE_STEPS steps of ``main``'s clock: K2 once
          and K1's segmented route twice a step, timed beside ``main``.
  sync_hier  ``sync_main`` under ``--tiers 10,2``, 20 rounds: K1 twice a
          round, per-node Var[X].
  defense_contracts  slice E's contracts on ``fault_contracts``' fleet,
          TF32 off and cuDNN deterministic inside the check (restored
          after): defense off adds no state key and no sub-stream;
          ``threshold=inf`` with mtd (window 2) armed equals the calm run in
          both engines, per step and chunked; the ARMED run (threshold 0.3,
          mtd window 2, scale_attack x -3 on a quarter of the fleet) and the
          collusion + learned + ``fault_exposure`` run under ``collude``
          give ``run_chunk`` == per-step steps in both engines; a crash
          after 3 steps of an armed mtd + collusion run resumes for 3 equal
          to 6 uninterrupted, the ``defense`` stream included; one replayed
          armed run's discrete outputs (pops, ages, ``status``, ``level``,
          ``win``, the counters) equal the CPU port's; under CUDA's sync
          debug mode an mtd run makes one host read per closed window (2 in
          4 steps) and the collusion runs none. K1 (the robust center)
          launches.
  async_defense  ``main``'s configuration cut to 10 steps under the pinned
          attack (scale_attack x -3 on a quarter of the fleet, every pop)
          with ``--defense --collusion`` (threshold 0.55, ewma 0.5) and
          ``fault_exposure``: K2 and K1 (the robust center) one launch a
          step, no host sync in two steps, the ``def_*`` counters, recall
          and false-positive rate against the exposure, steady ms a step
          beside ``main``'s, device-busy share and peak memory.
  sync_defense  ``sync_main`` cut to 20 rounds under
          ``benchmarks/bench_defense.py``'s pinned attack and knobs: (a) the
          trim ladder over fedavg under scale_attack x -3 on a quarter of
          the fleet, (b) the family ladder (10 rounds), (c) the collude
          coalition under collusion scoring with the learned head. Each run
          ends finite with two K1 launches a round (fedavg and the robust
          center; more when the ``norm_clip`` rung is taken), (a)
          quarantines and flags an exposed client; recall, false-positive
          rate, the mtd level, the detector AUC, accuracy beside
          ``sync_attack``'s fedavg and ms a round are printed.
  shard_contracts  slice F's contracts on ``fault_contracts``' fleet, cuDNN
          deterministic inside (restored after): a world of one on NCCL in
          this process — ``ShardedAsyncEngine`` equals ``AsyncEngine``
          bitwise per step and chunked for markov, oldest_age and
          round_robin under fedbuff and fedavg, under hierarchical (4, 2)
          with a heartbeat and under the armed defense with collusion — and a
          world of two through gloo, both ranks spawned on cuda:0
          (``launch/ranks.py``): sharded == one device bitwise, the
          cohort-parallel async and sync runs allclose to the replicated
          runs at the CPU tests' tolerance. Each check prints its backend.
  sharded_main ``main``'s configuration under ``--mesh-shards 1`` on NCCL
          (TF32 as ``main`` ran it): final params and selection history
          bitwise ``main``'s, K2 once a step (the rank's local pop), the host
          syncs of two steps, the collectives of one step and their bytes,
          the steady ms a step beside ``main``'s with a profiler window as
          ``main``'s, the state bytes the rank holds beside ``main``'s and
          peak memory; then
          ``oldest_age_step_sharded`` at 1M clients, k = 150 000, on the
          world of one: one K3 launch, its mask the ``oldest_age`` policy's
          on the same scores, and its time.
  kernel_k4    K4 (``flash_attention``) against its plain version on the
          card at the serving prefill shape (B, Hk, G, S, D) =
          (4, 4, 8, 2048, 64) in bf16, contiguous and in the model's layout
          (q a view of (B, S, H, D)), at the reference's test shapes
          (sliding, chunked, D = 128, uneven blocks; f32 to 2e-5, bf16 to
          2e-2) and at the bf16 kernel's shapes in the model's layout (G in
          1, 2, 4, 5, 8, 16; D in 32, 64, 128; S in 200, 384, 2048; sliding
          and chunked windows of 100 and 128); two launches bitwise equal;
          its time in the model's layout and contiguous (CUDA events and
          device-only), TFLOP/s and share of the bound, the plain version's
          time, and ``scaled_dot_product_attention`` (kv heads expanded) as
          yardstick.
  kernel_k5    the same for K5 (``flash_decode``) at the serving decode
          shape (8, 4, 8, 640, 64) in bf16, cache full, read in the model's
          (B, L, Hk, D) layout, at the reference's test shapes (per-batch
          valid_len, a partial cache, L not a multiple of any tile) and at
          cases that cut a split (L of 100 and 643; valid_len of 1, inside
          the first split, at a split edge, 0, and per row ending in
          different splits); the cluster size and CTA count; its time with
          the host's call and on the device;
          ``scaled_dot_product_attention`` with a boolean prefix mask as
          yardstick; and the serving tier's pool shape (8, 4, 8, 96, 64)
          with a ragged per-row valid_len from 1 to L, timed beside its
          plain version (``per_row_valid_len``).
  serve_main   tinyllama-1.1b at full width (22 layers, bf16, weights from
          seed 0): ``model.prefill`` at (B, S) = (4, 2048) must launch K4 22
          times; then ``repro_torch.launch.serve.serve`` at batch 8, prompt
          512, gen 128, temperature 0.8, whose every decode step (the prompt
          goes through ``prefill_tokens``, one decode step a token) launches
          K5 22 times, and no plain version or kernel-off route runs.
          Prefill and decode rates, decode ms per step beside the weight-read
          bound, the device-busy share of 10 decode steps, K4's and K5's
          share of device time, peak memory, and no host sync inside
          ``decode_step``. The reference's contract that ``model.prefill``'s
          last logits equal those of ``prefill_tokens`` over the same prompt
          is checked in f32 (TF32 off) and reported in bf16. Then
          ``graph_decode``: one ``model.decode_step`` at batch 8 captured in
          a CUDA graph, its logits bitwise equal to an eager step's from the
          same caches and token, and ms per step of 50 replays beside 50
          eager steps and the weight-read bound.
  serve_parity the reduced tinyllama in f32, TF32 off, from the same numpy
          weights on the card and on the CPU: ``model.prefill`` logits and
          ``serve``'s greedy tokens and logits equal within 1e-4, with K4
          and K5 launched on the card.
  kernel_k3    K3 (``aoi_topk``) against its plain version (a stable
          descending sort), sorted and unsorted, bit for bit: at the
          policy's shape (16384 scores, k = 256) on integer ages with and
          without the policy's [0, 0.5) noise, at the example's 1M clients
          with k = 128, on all-equal ages (lower indices first), k = 1,
          k = 1024, a ragged n, the paper's 15% cohort at 16 384, 100 000
          and 1M clients, k = n and signed zeros; graph replays; times as
          for K2 on the policy's unsorted call (and sorted), the ladder
          sorted and unsorted; ``make_policy("oldest_age", 1M, 150 000)``
          stepped 3 times: one K3 launch a step, masks of exactly k equal
          to the CPU's plain route, ms a step beside markov's.
  async_oldest ``repro_torch.launch.fl_async`` in ``main``'s configuration
          under ``--policy oldest_age``, 10 steps: K3 launched once a step
          (its ``_topk_idx`` at fleet scale), every policy mask exactly k,
          no host sync in two steps; steps/s, device-busy share, peak memory.
  kernel_k6    K6 (``ssd_scan``) against its plain version (the port's
          ``ssd_chunked``) at mamba2-370m's prefill shape (B, S, nh, hd, ds)
          = (4, 2048, 32, 64, 128), chunk 256, bf16 x/B/C sliced from a
          conv-output-shaped buffer, and at smaller f32 and bf16 shapes (a
          chunk that is not a multiple of 64 rows, contiguous inputs), each
          from a zero state and from a random h0, four chunks and chunks of
          64: y and ``h_final`` within K6_TOL, two launches bitwise equal;
          its time, the plain version's, the bound (its inputs and outputs
          against the tensor-core schedule's operations) beside the same
          with the schedule's workspace and the FMA schedule's bound, the
          phase count and the bf16 terms (no single PyTorch call computes
          the scan).
  ssm_serve_main  mamba2-370m at full width and depth (48 layers, bf16,
          weights from seed 0): ``model.prefill`` at (4, 2048) must launch K6
          48 times (prefill tokens/s, K6's share of device time); then
          ``serve`` at batch 8, prompt 256, gen 128 (its prompt goes through
          ``prefill_tokens``, so it launches no K6): decode ms per step,
          kernel launches per step, device-busy share, peak memory, no host
          sync in a decode step.
  ssm_parity   the reference's prefill/decode contract on mamba2: the
          reduced model in f32 (TF32 off), ``model.prefill`` (K6) against
          ``prefill_tokens`` for logits, state and conv window, and against
          the CPU's plain route; then mamba2-370m at full width, f32 held to
          CONSISTENCY_TOL and the bf16 gap and top-1 agreement reported.
  serve_loop   slice H's serving tier on tinyllama-1.1b at full width and
          depth (bf16, weights from seed 0), over a ring of SERVE_RING_H
          versions (slot v holds the params times 1 + 0.01 v, 8.8 GB). (a)
          Contracts: six requests joining and leaving around each other on
          2 replicas x 4 slots (round_robin, prompt 16, gen 3-5), each
          stream's tokens bitwise its decode alone in a pool of the same
          width on the same version, Var[X] = 0 and E[X] = 2; then three
          replicas at stagger 0 under ``replica_crash`` at 0.15: crashes
          and failovers happen, every stream completes, the tokens equal
          the calm run's. (b) SERVE_TRACE timed: a ``sample_requests`` trace
          (lognormal, rate 1 a tick, prompt 32, median gen 32, 24 ticks)
          through the markov router on 2 replicas x 8 slots: ms a tick,
          decode tokens/s, TTFT in ticks and ms, staleness, Var[X] and E[X]
          over replicas, host reads a tick, peak memory. Each part's K5
          launches are exactly 22 a decode step it counts (every pool tick
          and every join token); no plain version runs; the pool tick makes
          no host sync; its device-busy share, and the tick replayed from a
          CUDA graph (logits bitwise the eager tick's) beside eager ticks.
  serve_fleet  ``repro_torch.launch.serve_fleet.main`` at the reference's
          defaults (reduced tinyllama, 32 clients, k 8, 8 steps in chunks of
          4, ring H = 8, 2 replicas x 4 slots, markov, rate 1, prompt 8, gen
          8, 12 ticks a chunk), then with ``--crash-rate 0.1``: every
          chunk's head read of ``VersionStore.from_engine`` bitwise the
          engine's params, finite losses, every stream served (none dropped
          under crashes, and a crash happens), K5 once per layer per decode
          step; the driver's summary.

  kernel_k4_bwd  K4's backward (``csrc/flash_attention_bwd.cu``) against
          ``flash_attention_bwd_plain`` on the card: the training shape
          (4, 4, 8, 2048, 64) in bf16 in the model's layout, the forward
          phase's grid (G 1..16, D 32/64/128, S 200/384/2048, sliding and
          chunked windows of 100 and 128) and f32 at the reference's test
          shapes; the forward's lse within LSE_TOL of the plain
          log-sum-exp of the f32 inputs, which the plain backward takes;
          dq, dk, dv within BWD_TOL of each gradient's max, two
          launches bitwise equal, the forward's output bitwise the same
          with and without lse, ``vmap(grad)`` over a cohort of 4 bitwise
          equal to four single calls; its time beside its bound (10 D flops
          a head a causal pair), the plain version's and the backward of
          ``scaled_dot_product_attention`` with kv expanded.
  lm_train     tinyllama-1.1b at full width and depth (22 layers, bf16,
          weights from seed 0) trained by ``model.sgd_train_step`` at (4,
          2048), lr 3e-3, 5 steps on ``make_token_stream`` batches, remat
          on: K4 forward 2 x 22 and backward 22 launches a step, no plain or
          kernel-off attention, finite losses and params that moved, no
          host sync in a step; ms a step, tokens/s, the share of the bf16
          peak, device-busy share and K4's share in a profiler window, peak
          memory with remat on and off.
  lm_grad_parity  the reduced tinyllama in f32 (TF32 off) from the same
          weights on the card and the CPU: ``model.loss`` gradients at S =
          128 and 256 (K4 both ways on the card) within 1e-4 of each leaf's
          max, then one ``sgd_train_step``'s params allclose.
  train_main   ``repro_torch.launch.train`` at the reference's defaults
          (20M-param tinyllama variant, batch 8, seq 128, lr 3e-3, 200
          steps): K4 both ways every step, the loss falls; tokens/s, peak.
  fl_lm        ``fl_train --arch tinyllama-1.1b`` at the paper's sync
          settings for 10 rounds (K1 once a round: two grouped launches for
          the reduced LM's 21 leaves) and ``fl_async --arch`` at 16 384
          clients, k 256, 5 steps (K2 once a step): finite losses, peaks.
  kernel_k6_bwd  K6's backward (``csrc/ssd_scan_bwd.cu``) against
          ``ssd_chunked_bwd_plain`` on the card, TF32 off: mamba2-370m's
          training shape (4, 2048, 32, 64, 128), chunk 256, bf16 strided
          slices (the tensor-core route), f32 and bf16 at (hd, ds) = (32,
          16), (64, 64), (64, 128) with chunks 16, 64, 100 and 256 (both
          routes), h0 and dh_final absent and present, and a chunk whose
          sum dt |A| passes exp's f32 range; the plain side given the plain
          forward's entering states, the kernel forward's held to them at
          K6_TOL and its y bitwise to the forward without them; gradients
          within K6_BWD_TOL of each gradient's max, finite, two launches
          bitwise equal; its time beside its bound and the plain version's.
  ssm_train    mamba2-370m at full width and depth (48 layers, bf16,
          weights from seed 0) trained by ``model.sgd_train_step`` at (4,
          2048), lr 3e-3, 5 steps, remat on: K6 forward 2 x 48 and backward
          48 launches a step, no plain scan, finite losses and params that
          moved, no host sync in a step; ms a step, tokens/s, the share of
          the bf16 peak, device-busy share, K6's backward's share and its
          kernels' device time a launch, peak memory with remat on and off.
  ssm_grad_parity  the reduced mamba2 in f32 (TF32 off) from the same
          weights on the card and the CPU: ``model.loss`` gradients at S =
          64 and 128 within 1e-4 of each leaf's max, then one
          ``sgd_train_step``'s params allclose.
  fl_ssm       ``fl_train`` and ``fl_async`` with ``--arch mamba2-370m`` at
          ``fl_lm``'s settings (K1, K2, and K6 forward and backward under
          the clients' ``vmap(grad)``), then ``launch/train.py --arch
          mamba2-370m`` at ``train_main``'s settings: the loss falls.
  g3_serve     slice G3: gemma3-27b at full width and depth (62 layers, 52
          sliding with W = 1024 and 10 full, bf16): ``model.prefill`` at
          (2, 2048) with 62 K4 launches, 32 greedy decode steps with 62 K5
          launches each (the window rings are prefixes), no plain
          attention, no host sync in a step; prefill tokens/s, decode ms a
          step, device-busy share, peak memory; prefill of S - 1 tokens
          plus a decode step against prefill of S, held in f32 on one
          repeat of the pattern and reported in bf16 at full depth.
  g3_train     gemma3-27b at full width, one repeat (8 layers), 3
          ``sgd_train_step``s at (2, 2048) with remat: K4's sliding forward
          (14 launches a step) and backward (8), the loss falls.
  g3_families  deepseek-v2 (MLA + MoE, depth cut to 2 layers: prefill,
          decode, f32 absorbed-vs-decompressed and no-drop consistency, a
          train step), jamba (one repeat: K6 x 7, K4 x 1, K5 x 1 a step),
          pixtral-12b (full: 256 frontend embeddings + 1792 tokens), whisper
          (full, the serve driver with frames: K4 x 4, K5 x 4 a step) and
          llama4 reduced; seconds, peak memory and launches per family.
  g3_pool      the slot pool's churn and failover contracts for gemma3,
          deepseek-v2 and whisper (reduced) on the card.
  tp_contracts slice I1's contracts of the sharded LM step in f32, TF32 off,
          deterministic algorithms on: reduced tinyllama (kv repeated to
          MHA), gemma3, deepseek-v2, jamba, mamba2 and whisper; a world of
          one on NCCL in this process bit for bit the unsharded model; worlds
          of 2 (model 2) and 4 (model 4, data 2 x model 2) spawned on cuda:0
          over gloo (``launch/tp_cases.py``; collectives staged through host
          memory) within TP_TOL of each leaf's max of the one-device port
          (loss, moe_aux, every gradient, the params after an SGD step,
          prefill logits, every cache leaf, 8 decode steps); a case run twice
          repeats bit for bit.
  tp_main      tinyllama-1.1b at full width and depth, bf16, seed 0, on four
          ranks of cuda:0 over gloo, mesh (model 4) and (data 2 x model 2),
          built with ``explicit_tp`` and ``remat_save_outputs`` (the MLP's
          sums in bf16; the recompute stops before each branch's sum):
          one ``sgd_train_step`` at TRAIN_SHAPE (K4 2 x 22 forward and 22
          backward a rank, at (4/dp, 4/tp, 8, 2048, 64)), ``model.prefill``
          at PREFILL_SHAPE (K4 22) and TP_DECODE_STEPS decode steps from its
          caches (K5 22 a step on the rank's kv heads over the full
          2048-slot ring; the weights gathered whole over data once, as a
          serving replica holds them); mamba2-370m at model 2 on two ranks:
          a prefill at PREFILL_SHAPE, K6 48 times a rank on 16 of 32 heads.
          Per rank: launches and their shapes, ms a phase (staged through
          host: a correctness run, not a speed figure), peak memory, the
          loss and logits gaps against a world of one on NCCL (the loss
          within TP_LOSS_TOL); the prefill and decode logits held to an f32
          world of one on the same weights, within TP_WITNESS times the bf16
          world of one's gap from it; K4 both ways, K5 and K6 at the
          rank-local shapes against their plain versions.
  dryrun  slice I2's roofline and dry-run (``repro_torch.roofline``,
          ``launch/dryrun.py``) against the card: (a) ``roofline/hw.py``'s
          peaks beside the card's name, power limit, SMs and memory, a
          2 GiB device-to-device copy as a share of ``HBM_BW`` and a bf16
          8192^3 ``torch.matmul`` as a share of ``PEAK_FLOPS_BF16`` (a
          share above 1.05 fails: the constant would be wrong); (b)
          ``lm_train``'s step (tinyllama-1.1b, TRAIN_SHAPE, bf16, remat)
          under ``op_cost.analyze`` on the card and on the meta device:
          FLOPs, bytes written and the per-kernel tally equal exactly, the
          meta tally of K4 (44 forward, 22 backward) equal to the card's
          launch counts, and the step's measured ms beside the roofline's
          max(compute, memory); (c) the dry-run's collectives (calls and
          bytes by kind) of ``tp_main``'s tinyllama phases at model 4 and
          data 2 x model 2 equal to each live rank's, exactly; (d) the
          dry-run of tinyllama-1.1b train_4k and mamba2-370m prefill_32k on
          the 16 x 16 mesh, with their roofline terms.

The main, async_oldest and sync_main phases run before the parity phases,
which turn TF32 off; the slice C, D, E and F phases run after
``sync_parity``, and those timed beside ``main`` and ``sync_main``
(``sync_attack``, ``async_chaos``, ``async_hier``, ``sync_hier``,
``async_defense``, ``sync_defense``, ``sharded_main``) set TF32 back to
what ``main`` ran with while they run.
Then the ``{"kernels": [...]}`` line (K2, K1, K4, K5, K3, K6, K4's
backward, K6's backward; each count the sum over the paths that launch it:
K5's over ``serve_main``, ``serve_loop``'s timed run, ``serve_fleet``'s
default run, the G3 phases and ``tp_main``'s ranks), the card's
name and power limit as ``nvidia-smi`` reports them, and, last, the device
line. Any failure exits non-zero; without a GPU, or outside a checkout of
the repository, the script fails before printing a result. It imports
nothing of JAX.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings

_T0 = time.time()
ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): the port's one copy
from repro_torch.roofline.hw import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.roofline.hw import PEAK_FLOPS_BF16 as BF16_OPS_PER_S  # noqa: E402
from repro_torch.roofline.hw import PEAK_FLOPS_F32 as FP32_OPS_PER_S  # noqa: E402

SPIN_CYCLES = 4_000_000  # ~2 ms of SM clock: the lead device_ms gives the host
MAIN_ARGV = ["--dataset", "mnist", "--data-scale", "5", "--clients", "16384",
             "--k", "256", "--policy", "markov", "--latency-profile", "lognormal",
             "--rounds", "20"]
KERNEL_SHAPE = (16384, 256)  # (n, k) the main path gives K2
# (n, k) rungs of the top-k timing ladder (K2 and K3): the main path's
# shape, the paper's 15% cohort at 16 384, and 1M clients at both
TOPK_LADDER = ((16384, 256), (16384, 2458), (1_000_000, 256), (1_000_000, 150_000))
SYNC_ARGV = ["--dataset", "mnist", "--data-scale", "5", "--clients", "100",
             "--k", "15", "--m", "10", "--policy", "markov", "--local-epochs", "5",
             "--batch-size", "50", "--lr", "0.02", "--rounds", "60"]
FLEET = (16384, 256)  # (n, k) of the async main path, for K1's fleet width
K1_RTOL, K1_ATOL = 1e-5, 1e-6  # relative to sum_c |w_c P_cn|: f32 sums in two orders
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # the reference's kernel-test tolerances
LM_ARCH = "tinyllama-1.1b"
PREFILL_SHAPE = (4, 2048)  # (B, S) of model.prefill in serve_main
SERVE_ARGS = dict(batch=8, prompt_len=512, gen=128, temperature=0.8, seed=0)
# f32 prefill vs prefill_tokens at full width: the reference holds its own
# consistency to 3e-4 at 2 layers of width 256; 22 layers of width 2048
# sum f32 products over 8x longer rows in other orders (one S-token GEMM
# against S one-token GEMMs, K4 against K5), so the bound is widened 3.3x
CONSISTENCY_TOL = 1e-3
OLDEST_ARGV = ["--dataset", "mnist", "--data-scale", "5", "--clients", "16384",
               "--k", "256", "--policy", "oldest_age", "--latency-profile", "lognormal",
               "--rounds", "10"]  # main's configuration under the oldest-age policy
# K6 vs its plain version: both sum the same f32 products in other orders
# (and the plain version's cumsum is a parallel scan on the card)
K6_TOL = 1e-4
SSM_ARCH = "mamba2-370m"
SSM_SERVE_ARGS = dict(batch=8, prompt_len=256, gen=128, temperature=0.8, seed=0)
# slice H, the serving tier: serve_loop's ring, contracts and timed trace
SERVE_RING_H = 4
SERVE_CONTRACT = dict(requests=6, prompt_len=16, slots=4)  # gen 3-5, one arrival a tick
SERVE_CRASH = dict(n_replicas=3, rate=0.15, seed=1)
SERVE_TRACE = dict(profile="lognormal", rate=1.0, prompt_len=32, gen_len=32, ticks=24,
                   n_replicas=2, slots=8, router="markov", seed=0)
SERVE_FLEET_ARGV = ["--device", "cuda"]  # the reference driver's defaults otherwise


def emit(obj) -> None:
    if "phase" in obj:  # where the script's time goes, phase by phase
        obj = {**obj, "elapsed_s": time.time() - _T0}
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, calls: int = 100, trials: int = 7, warmup: int = 10) -> float:
    """Median per-call device time of ``fn`` over ``trials`` runs of
    ``calls`` back-to-back calls, timed with CUDA events after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / calls)
    return statistics.median(per_call)


def device_ms(torch, fn, calls: int = 20) -> float:
    """Per-call device time of ``fn``, without the host's launch overhead:
    CUDA events around each call, enqueued behind a ~2 ms spin kernel
    (``torch.cuda._sleep``) so that the host has queued the whole call
    before the device reaches it. The profiler is not used here: late in a
    long process it kept only 7 to 13 of 20 kernel records of a call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(calls):
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / calls


def _same_bits(torch, out, plain) -> bool:
    """Values bit for bit (-0.0 is not +0.0) and indices equal."""
    (v, i), (pv, pi) = out, plain
    return torch.equal(v.view(torch.int32), pv.view(torch.int32)) and torch.equal(i, pi)


def _graph_replay_equal(torch, fn) -> bool:
    """One call of ``fn`` captured in a CUDA graph: its replay's output bit
    for bit the eager call's (a capture that fails raises)."""
    side = torch.cuda.Stream()  # warm up off the default stream, as capture wants
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn()
    eager = fn()
    graph.replay()
    torch.cuda.synchronize()
    return _same_bits(torch, captured, eager)


def _topk_bound_ms(n, k) -> float:
    """Values in once; f32 values and i64 indices out once; one comparison
    per element is the least a selection needs."""
    return max((n * 4 + k * (4 + 8)) / HBM_BYTES_PER_S, n / FP32_OPS_PER_S) * 1e3


def _ladder(torch, run, library, make, sorted_options):
    """Each rung of TOPK_LADDER: the kernel's ms and device ms beside its
    bound and ``torch.topk`` of the same ``sorted`` (the yardstick; the port
    never calls it)."""
    rungs = []
    for n, k in TOPK_LADDER:
        x = make(n)
        for sorted_ in sorted_options:
            fn = lambda: run(x, k, sorted_)  # noqa: E731
            lib = lambda: library(x, k, sorted_)  # noqa: E731
            rungs.append({"n": n, "k": k, "sorted": sorted_, "ms": cuda_ms(torch, fn),
                          "device_ms": device_ms(torch, fn),
                          "bound_ms": _topk_bound_ms(n, k),
                          "torch_topk_ms": cuda_ms(torch, lib),
                          "torch_topk_device_ms": device_ms(torch, lib)})
    return rungs


def phase_kernel(torch, event_topk):
    from repro_torch.sim import events

    gen = torch.Generator(device="cuda").manual_seed(0)

    def times(n, frac):
        t = torch.rand(n, generator=gen, device="cuda") * 100
        pending = torch.rand(n, generator=gen, device="cuda") < frac
        return torch.where(pending, t, torch.inf)

    def signed_zeros(n):
        z = torch.where(torch.rand(n, generator=gen, device="cuda") < 0.5, 0.0, -0.0)
        return torch.where(torch.rand(n, generator=gen, device="cuda") < 0.05, 1.0, z)

    cases = [(f"n{n}_k{k}", times(n, 0.3), k)
             for n in (16384, 65536, 1_000_003, 2**20) for k in (8, 256)]
    cases += [(f"n{n}_k{k}", times(n, 0.3), k)
              for n in (65536, 2**20) for k in (1024, 4096, 16384)]
    cases += [
        ("all_ties", torch.full((16384,), 5.0, device="cuda"), 256),
        ("all_idle", torch.full((65536,), float("inf"), device="cuda"), 8),
        ("fewer_than_k", times(1_000_003, 100 / 1_000_003), 256),
        ("fewer_than_k_4096", times(2**20, 1000 / 2**20), 4096),
        ("signed_zeros", signed_zeros(16384), 256),
        ("signed_zeros_grid", signed_zeros(65536), 4096),
        ("k_equals_n", times(32768, 0.5), 32768),
    ]
    launches_per_call = {}
    for name, t, k in cases:
        before = event_topk.launches
        out = event_topk.event_topk(t, k)
        plain = event_topk.next_k_plain(t, k)
        torch.cuda.synchronize()
        if not _same_bits(torch, out, plain):
            raise AssertionError(f"K2 disagrees with its plain version: {name}")
        if event_topk.launches - before != 1:
            raise AssertionError(f"K2 counted {event_topk.launches - before} calls: {name}")
        launches_per_call[name] = event_topk.plan(t.shape[0], k, True).launches
        if name == "all_ties" and not torch.equal(out[1].cpu(), torch.arange(k)):
            raise AssertionError("K2 tie order is not lower-index-first")
    if set(launches_per_call.values()) != {1}:
        raise AssertionError(f"K2 plans more than one launch a call: {launches_per_call}")

    # the pop of fl_async --clients 65536 --k 2048, kernel against plain
    ev = {**events.init_event_state(65536, "cuda"), "t_done": times(65536, 0.05)}
    before = event_topk.launches
    popped = events.pop_events(ev, 2048)
    plain_pop = events.pop_events(ev, 2048, use_kernel=False)
    torch.cuda.synchronize()
    if event_topk.launches - before != 1 or not (
            _same_bits(torch, popped[:2], plain_pop[:2])
            and torch.equal(popped[2], plain_pop[2])
            and torch.equal(popped[3]["t_done"].view(torch.int32),
                            plain_pop[3]["t_done"].view(torch.int32))):
        raise AssertionError("K2's pop of (65536, 2048) disagrees with the plain pop")

    n, k = KERNEL_SHAPE
    t = times(n, 0.02)  # the main path's t_done: ~1-2% of the fleet in flight
    big = times(1_000_000, 0.3)
    graphs = {"n16384_k256": _graph_replay_equal(torch, lambda: event_topk.event_topk(t, k)),
              "n1000000_k150000": _graph_replay_equal(
                  torch, lambda: event_topk.event_topk(big, 150_000))}
    if not all(graphs.values()):
        raise AssertionError(f"K2 graph replay differs from the eager call: {graphs}")
    ms = cuda_ms(torch, lambda: event_topk.event_topk(t, k))
    plain_ms = cuda_ms(torch, lambda: event_topk.next_k_plain(t, k))
    library_ms = cuda_ms(torch, lambda: torch.topk(t, k, largest=False))
    entry = {
        "name": "event_topk", "route": "cuda",
        "source": "src/repro_torch/csrc/event_topk.cu",
        "replaces": "src/repro/kernels/event_topk.py:48",
        "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": _topk_bound_ms(n, k), "bound_by": "bytes", "library_ms": library_ms,
    }
    ladder = _ladder(torch, lambda x, kk, s: event_topk.event_topk(x, kk),
                     lambda x, kk, s: torch.topk(x, kk, largest=False, sorted=s),
                     lambda size: times(size, 0.3), (True,))
    emit({"phase": "kernel", "ok": True, "cases": len(cases), "n": n, "k": k,
          "plan": event_topk.plan(n, k, True)._asdict(),
          "launches_per_call": launches_per_call, "pop_65536_2048_equal": True,
          "graph_replay_equal": graphs, **entry,
          "device_ms": device_ms(torch, lambda: event_topk.event_topk(t, k)),
          "plain_device_ms": device_ms(torch, lambda: event_topk.next_k_plain(t, k)),
          "library_device_ms": device_ms(
              torch, lambda: torch.topk(t, k, largest=False)),
          "empty_kernel_device_ms": device_ms(torch, lambda: torch.cuda._sleep(0)),
          "ladder": ladder})
    return entry


def _state_tensors(tree, path=""):
    if isinstance(tree, dict):
        for key, val in tree.items():
            yield from _state_tensors(val, f"{path}/{key}")
    else:
        yield path, tree


def phase_main(torch, event_topk):
    from repro_torch.core import load_metric
    from repro_torch.engine.sharded import per_device_state_bytes
    from repro_torch.launch import fl_async

    args = fl_async.parse_args(MAIN_ARGV)
    t0 = time.time()
    task, engine = fl_async.build(args)
    setup_s = time.time() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gib = torch.cuda.memory_allocated() / 2**30  # the task, before the run
    event_topk.launches = 0
    res, state = _run_captured(engine, progress=True)
    launches = event_topk.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    fl_async.report(res, args)

    cfg = res.config
    off = [p for p, t in _state_tensors(state)
           if not (isinstance(t, torch.Tensor) and t.is_cuda)]
    if off:
        raise AssertionError(f"engine state off the GPU: {off}")
    if launches < cfg.rounds:
        raise AssertionError(f"K2 launched {launches} times in {cfg.rounds} steps")
    evals = [r.eval_loss for r in res.records]
    trains = [r.train_loss for r in res.records if r.buffer_fill > 0]
    if not all(map(math.isfinite, evals + trains)) or len(res.records) != cfg.rounds:
        raise AssertionError(f"non-finite losses: eval {evals} train {trains}")
    ws, ls = res.wall_stats, res.load_stats
    # E[X] by the renewal identity E[X] = n / E[cohort]: over 20 steps the
    # per-dispatch samples of X are cut short by the run (a client's first
    # sample is its steady-state start age, and gaps of ~n/k steps do not
    # fit in the run), so their mean is not E[X]
    target = cfg.n_clients / cfg.k
    mean_x = cfg.n_clients / ls["mean_cohort"]
    if abs(mean_x - target) > 0.15 * target:
        raise AssertionError(f"E[X] {mean_x} far from n/k = {target}")
    out = {
        "phase": "main", "ok": True, "argv": MAIN_ARGV,
        "kernel_launches": launches, "steps": cfg.rounds,
        "steps_per_s": cfg.rounds / res.wall_time_s,
        "wall_time_s": res.wall_time_s, "setup_s": setup_s,
        "eval_loss": evals[-1], "accuracy": res.records[-1].accuracy,
        "mean_X": mean_x, "n_over_k": target, "mean_cohort": ls["mean_cohort"],
        "mean_X_epoch": ws["mean_X_epoch"], "var_X_epoch": ws["var_X_epoch"],
        "var_X_round": ls["var_X"], "x_round_samples": ls["num_samples"],
        "random_selection_var": load_metric.random_selection_var(cfg.n_clients, cfg.k),
        "optimal_var": load_metric.optimal_var(cfg.n_clients, cfg.k, cfg.m),
        "mean_staleness": ws["mean_staleness"],
        "peak_mem_gib": peak_gib, "base_mem_gib": base_gib,
        "tf32": {"cudnn": torch.backends.cudnn.allow_tf32,
                 "matmul": torch.backends.cuda.matmul.allow_tf32},
    }
    state, syncs = sync_free_steps(torch, engine, state, cfg.rounds)
    if syncs:
        raise AssertionError(f"a step synchronized with the host: {syncs}")
    out["host_syncs_in_2_steps"] = 0
    out.update(steady_and_profile(torch, engine, state, cfg.rounds + 2,
                                  res.wall_time_s))
    emit(out)
    calm = {"steady_ms_per_step": out["steady_ms_per_step"],
            "clock_per_step": ws["sim_time"] / cfg.rounds, "tf32": out["tf32"],
            "params": res.params, "selection": res.selection,
            "state_bytes": per_device_state_bytes(state),
            "peak_mem_gib": peak_gib, "base_mem_gib": base_gib}
    return launches, calm


def _run_captured(engine, progress=False):
    """``run_engine(engine)`` and the engine state it ended with (what
    ``finalize`` was handed)."""
    from repro_torch.engine import run_engine

    captured = {}
    finalize = engine.finalize

    def capture(state, *rest):
        captured["state"] = state
        return finalize(state, *rest)

    engine.finalize = capture
    try:
        res = run_engine(engine, progress=progress)
    finally:
        engine.finalize = finalize
    return res, captured["state"]


def sync_free_steps(torch, engine, state, r0, steps=2):
    """Run ``steps`` steps as one chunk under
    ``torch.cuda.set_sync_debug_mode``; returns the new state and the
    messages of every synchronizing CUDA operation they made. A known sync
    (``.item()``) right after is the control: the mode must report it."""
    def is_sync(w):
        # torch warns "called a synchronizing CUDA operation" for each one;
        # its one-off notice that the mode is a prototype is not one
        msg = str(w.message)
        return "synchroniz" in msg and "prototype feature" not in msg

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            state, _ = engine.run_chunk(state, r0, steps, False)
            in_steps = len(caught)
            torch.zeros((), device="cuda").item()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    if not any(map(is_sync, caught[in_steps:])):
        raise AssertionError("sync debug mode missed a known sync (.item())")
    return state, [str(w.message) for w in caught[:in_steps] if is_sync(w)]


def _loop(engine, state, r0, steps, eval_every=1):
    """``run_engine``'s loop at the driver's cadence: one step per chunk,
    its aux to the host, and every ``eval_every`` steps an eval and its
    record."""
    for r in range(r0, r0 + steps):
        state, aux = engine.run_chunk(state, r, 1, False)
        aux = {k: v.cpu().numpy() for k, v in aux.items()}
        if (r + 1) % eval_every == 0:
            engine.record(r, {k: v[-1] for k, v in aux.items()},
                          engine.evaluate(state))
    return state


def _steady_ms(torch, engine, state, r0, steps, eval_every):
    """Host-clock ms a step over ``steps`` more steps of the driver's loop."""
    torch.cuda.synchronize()
    t0 = time.time()
    state = _loop(engine, state, r0, steps, eval_every)
    torch.cuda.synchronize()
    return (time.time() - t0) * 1e3 / steps, state


def _union_ms(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals in microseconds,
    as ms: device time with any kernel running, overlaps counted once."""
    total, cur_s, cur_e = 0.0, None, None
    for start, end in sorted(intervals):
        if cur_e is None or start > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = start, end
        else:
            cur_e = max(cur_e, end)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def steady_and_profile(torch, engine, state, r0, wall_time_s, steps=10, prof_steps=3,
                       match=None, eval_every=1):
    """Steady-state step time (host clock over ``steps`` more steps of the
    driver's loop, after the counted run, with an eval every
    ``eval_every`` steps), the first run's warm-up derived from it, and
    device time by kernel over ``prof_steps`` further steps
    (``torch.profiler``): summed kernel time, and the union of the kernel
    intervals over the window's host-clock wall time (kernels that
    overlap count once). With ``match``, also the device time per step of
    the kernels whose name contains it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    steady_ms, state = _steady_ms(torch, engine, state, r0, steps, eval_every)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        _loop(engine, state, r0 + steps, prof_steps, eval_every)
        torch.cuda.synchronize()
        window_ms = (time.time() - t0) * 1e3
    rows = sorted(((ev.self_device_time_total / 1e3, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA
                   and ev.self_device_time_total > 0), reverse=True)
    busy_ms = sum(r[0] for r in rows) / prof_steps if rows else None
    union_ms = _union_ms((ev.time_range.start, ev.time_range.end)
                         for ev in prof.events()
                         if ev.device_type == DeviceType.CUDA)
    extra = {}
    if match and rows:
        extra[f"{match}_device_ms_per_step"] = sum(
            ms for ms, name, _ in rows if match in name) / prof_steps
    if union_ms > 0:
        extra["device_union_ms_per_step"] = union_ms / prof_steps
        extra["device_union_share_of_window"] = union_ms / window_ms
        extra["profiled_window_ms_per_step"] = window_ms / prof_steps
    return {
        **extra,
        "steady_ms_per_step": steady_ms, "steady_steps_per_s": 1e3 / steady_ms,
        "warmup_s": wall_time_s - engine.cfg.rounds * steady_ms / 1e3,
        "device_busy_ms_per_step": busy_ms if rows else "not measured",
        "device_busy_share": busy_ms / steady_ms if rows else "not measured",
        "profile_top": [{"ms_per_step": ms / prof_steps, "name": name[:90],
                         "calls_per_step": count / prof_steps}
                        for ms, name, count in rows[:12]],
    }


def _replay(n, k, m, steps, epochs, examples, shapes, seed=0):
    """Fixed numpy draws for every site of the calm async path."""
    import numpy as np

    from repro_torch.core import load_metric

    rng = np.random.default_rng(seed)
    pi = load_metric.steady_state(load_metric.optimal_probs(n, k, m))
    init = {f"params/{name}": rng.standard_normal(shape).astype(np.float32)
            for name, shape in shapes.items()}
    init["policy_init"] = rng.choice(m + 1, size=n, p=pi)
    init["speed"] = rng.standard_normal(n).astype(np.float32)
    per_step = []
    for _ in range(steps):
        per_step.append({
            "select": rng.random(n, dtype=np.float32),
            "latency_compute": rng.standard_normal(n).astype(np.float32),
            "latency_comm": rng.exponential(size=n).astype(np.float32),
            "local_perm": np.argsort(rng.random((k, epochs, examples)), axis=-1),
        })
    return init, per_step


def phase_parity(torch):
    import numpy as np

    from repro_torch.configs.paper_cnn import MNIST_CNN
    from repro_torch.core.draws import ReplayDraws
    from repro_torch.data.synthetic import load_dataset
    from repro_torch.engine import RunConfig, make_engine
    from repro_torch.fl import make_cnn_task
    from repro_torch.kernels import event_topk
    from repro_torch.sim import events as ev_mod

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    n, k, m, steps, epochs = 48, 8, 10, 6, 2
    train, test = load_dataset("mnist", seed=0, scale=0.02)
    s = MNIST_CNN.image_size // 4
    shapes = {"conv1": (5, 5, 1, 32), "conv2": (5, 5, 32, 64),
              "fc1": (s * s * 64, 512), "fc2": (512, 10)}

    def run(device, use_kernel):
        task = make_cnn_task(MNIST_CNN, train, test, n, seed=0, device=device)
        init, per_step = _replay(n, k, m, steps, epochs, task.examples_per_client,
                                 shapes)
        cfg = RunConfig(mode="async", n_clients=n, k=k, m=m, policy="markov",
                        rounds=steps, local_epochs=epochs, batch_size=50,
                        lr0=0.02, seed=0, profile="lognormal",
                        use_kernel=use_kernel)
        engine = make_engine(task, cfg, draws=ReplayDraws(init, per_step, device))
        pops, orig = [], ev_mod.pop_events

        def recording(ev, kk, *, use_kernel=None):
            out = orig(ev, kk, use_kernel=use_kernel)
            pops.append((out[1].cpu(), out[2].cpu()))
            return out

        ev_mod.pop_events = recording
        try:
            state = engine.init()
            trace = []
            for r in range(steps):
                state, aux = engine.step(state, r)
                trace.append({
                    "send": aux["send"].cpu(), "version": int(state["version"]),
                    "ages": state["sched"]["ages"].cpu(),
                    "disp_ver": state["ev"]["disp_ver"].cpu(),
                    "clock": float(state["clock"]),
                    "params": {f"{a}.{b}": v.cpu() for a, lv in state["params"].items()
                               for b, v in lv.items()},
                })
        finally:
            ev_mod.pop_events = orig
        return trace, pops

    launches_before = event_topk.launches
    runs = {"cuda_kernel": run("cuda", True), "cuda_plain": run("cuda", False),
            "cpu_plain": run("cpu", False)}
    ref_trace, ref_pops = runs["cpu_plain"]
    worst = 0.0
    for name, (trace, pops) in runs.items():
        for r in range(steps):
            a, b = trace[r], ref_trace[r]
            same = (torch.equal(a["send"], b["send"]) and a["version"] == b["version"]
                    and torch.equal(a["ages"], b["ages"])
                    and torch.equal(a["disp_ver"], b["disp_ver"])
                    and torch.equal(pops[r][0], ref_pops[r][0])
                    and torch.equal(pops[r][1], ref_pops[r][1]))
            if not same:
                raise AssertionError(f"parity: {name} step {r} discrete outputs differ")
            if abs(a["clock"] - b["clock"]) > 1e-6 * abs(b["clock"]):
                raise AssertionError(f"parity: {name} step {r} clock differs")
            for key, val in a["params"].items():
                if not torch.allclose(val, b["params"][key], rtol=1e-4, atol=1e-5):
                    raise AssertionError(f"parity: {name} step {r} {key} differs")
                worst = max(worst, float((val - b["params"][key]).abs().max()))
    if event_topk.launches - launches_before < steps:
        raise AssertionError("parity: the cuda_kernel run did not launch K2 every step")
    emit({"phase": "parity", "ok": True, "runs": list(runs), "steps": steps,
          "popped": int(sum(int(v.sum()) for _, v in ref_pops)),
          "kernel_launches": event_topk.launches - launches_before,
          "max_param_abs_diff_vs_cpu": worst, "tf32": False})


def phase_kernel_k1(torch, fedavg_reduce):
    from repro_torch.configs.paper_cnn import MNIST_CNN
    from repro_torch.core.draws import GeneratorDraws
    from repro_torch.core.tree import tree_leaves
    from repro_torch.engine.config import default_cohort_width
    from repro_torch.models.cnn import init_params

    gen = torch.Generator(device="cuda").manual_seed(1)
    leaves = [t.numel() for t in tree_leaves(init_params(GeneratorDraws(0, "cuda"),
                                                         MNIST_CNN))]
    width = default_cohort_width(100, 15)  # the sync main path's cohort slots
    fleet_width = default_cohort_width(*FLEET)

    def stack(C, N, active, offset=0):
        """(C, N) params with ``active`` leading 0/1-mask slots, as
        ``cohort_indices`` lays a cohort out; ``offset`` floats in, so the
        pointer loses its 16-byte alignment."""
        buf = torch.randn(C * N + offset, generator=gen, device="cuda")
        w = (torch.arange(C, device="cuda") < active).to(torch.float32)
        return buf[offset:].view(C, N), w

    def check(name, P, w):
        out = fedavg_reduce.fedavg_reduce(P, w)
        again = fedavg_reduce.fedavg_reduce(P, w)
        plain = fedavg_reduce.fedavg_reduce_plain(P, w)
        scale = (w.abs()[:, None] * P.abs()).sum(0)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise AssertionError(f"K1 launches differ bitwise: {name}")
        err = (out - plain).abs()
        if bool((err > K1_RTOL * scale + K1_ATOL).any()):
            raise AssertionError(f"K1 disagrees with its plain version: {name}")
        exact = (w.double()[:, None] * P.double()).sum(0)
        f64_err[name] = {"kernel": float((out.double() - exact).abs().max()),
                         "plain": float((plain.double() - exact).abs().max())}
        return float(err.max())

    main_cases = [(f"c{width}_n{N}", *stack(width, N, 15)) for N in leaves]
    # one sync round: the eight leaves share one cohort's weights, one launch
    round_w = main_cases[0][2]
    round_stacks = [P for _, P, _ in main_cases]
    before = fedavg_reduce.launches
    grouped = fedavg_reduce.fedavg_reduce_leaves(round_stacks, round_w)
    round_launches = fedavg_reduce.launches - before
    singles = [fedavg_reduce.fedavg_reduce(P, round_w) for P in round_stacks]
    torch.cuda.synchronize()
    if round_launches != 1:
        raise AssertionError(f"K1 took {round_launches} launches for one round's tree")
    if not all(torch.equal(g, s1) for g, s1 in zip(grouped, singles)):
        raise AssertionError("K1's grouped launch differs bitwise from single-leaf launches")
    fleet_case = (f"c{fleet_width}_n{max(leaves)}",
                  *stack(fleet_width, max(leaves), FLEET[1]))
    edge_cases = [
        ("c1_n17", *stack(1, 17, 1)),
        ("c7_n1001", *stack(7, 1001, 5)),
        ("zero_weights", *stack(width, 5120, 0)),
        ("unaligned", *stack(width, 1024, 15, offset=1)),
        ("c2050_n4096", *stack(2050, 4096, 1500)),  # weights staged in 2+ chunks
    ]
    if edge_cases[3][1].data_ptr() % 16 == 0:
        raise AssertionError("the unaligned case is aligned")
    cases = main_cases + [fleet_case] + edge_cases
    f64_err = {}
    max_err = max(check(name, P, w) for name, P, w in cases)

    def timed(name, P, w):
        C, N = P.shape
        return {
            "case": name, "C": C, "N": N,
            "ms": cuda_ms(torch, lambda: fedavg_reduce.fedavg_reduce(P, w)),
            "device_ms": device_ms(torch, lambda: fedavg_reduce.fedavg_reduce(P, w)),
            "plain_ms": cuda_ms(torch, lambda: fedavg_reduce.fedavg_reduce_plain(P, w)),
            "library_ms": cuda_ms(torch, lambda: torch.mv(P.t(), w)),
            "library_device_ms": device_ms(torch, lambda: torch.mv(P.t(), w)),
            # each input read once, the output written once; 2*C*N flops
            "bound_ms": max((C * N + C + N) * 4 / HBM_BYTES_PER_S,
                            2 * C * N / FP32_OPS_PER_S) * 1e3,
        }

    segmented = _k1_segmented(torch, fedavg_reduce, leaves)
    rows = [timed(*case) for case in main_cases + [fleet_case]]
    per_round = rows[:len(main_cases)]
    # one sync round: one grouped launch for the eight leaves; the plain
    # version and the yardstick (torch.mv) take one call per leaf
    run = lambda: fedavg_reduce.fedavg_reduce_leaves(round_stacks, round_w)  # noqa: E731
    singles_run = lambda: [fedavg_reduce.fedavg_reduce(P, round_w)  # noqa: E731
                           for P in round_stacks]
    mv_run = lambda: [torch.mv(P.t(), round_w) for P in round_stacks]  # noqa: E731
    entry = {
        "name": "fedavg_reduce", "route": "cuda",
        "source": "src/repro_torch/csrc/fedavg_reduce.cu",
        "replaces": "src/repro/kernels/fedavg_reduce.py:35",
        "max_abs_err": max(max_err, segmented["segmented_max_abs_err"]),
        "ms": cuda_ms(torch, run),
        "plain_ms": cuda_ms(torch, lambda: [fedavg_reduce.fedavg_reduce_plain(P, round_w)
                                            for P in round_stacks]),
        "bound_ms": sum(r["bound_ms"] for r in per_round),
        "bound_by": "bytes",
        "library_ms": cuda_ms(torch, mv_run),
    }
    emit({"phase": "kernel_k1", "ok": True, "cases": len(cases), "width": width,
          "leaves": leaves, "per_round": "one grouped launch for the round's eight leaves",
          "round_launches": round_launches, "grouped_bitwise_single_leaf": True,
          **entry, "device_ms": device_ms(torch, run),
          "single_leaf_launches_ms": cuda_ms(torch, singles_run),
          "single_leaf_launches_device_ms": device_ms(torch, singles_run),
          "library_device_ms": device_ms(torch, mv_run),
          "rows": rows, "max_abs_err_vs_f64": f64_err, **segmented})
    return entry


def _k1_segmented(torch, fedavg_reduce, leaves):
    """K1's segmented route (the tier merges of the tiered aggregation)
    against its plain version on the card: each case within K1's tolerance
    of ``segment_reduce_plain`` (NaN positions equal), launches bitwise
    repeatable; then ``async_hier``'s tier 0 timed: the (256, paper CNN)
    delta stack over 64 nodes in one launch for the eight leaves, beside the
    flat launch on the same stack, the plain version, a one-hot ``torch.mm``
    and the bytes bound."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    B, E0 = FLEET[1], 64

    def case(name, C, N, E, offset=0):
        P = torch.randn(C * N + offset, generator=gen, device="cuda")[offset:].view(C, N)
        w = torch.rand(C, generator=gen, device="cuda") + 0.1
        seg = torch.randint(0, E, (C,), generator=gen, device="cuda", dtype=torch.int32)
        if name == "one_node":
            seg.zero_()
        elif name == "own_node":
            seg = torch.arange(C, device="cuda", dtype=torch.int32)
        elif name == "empty_node":
            seg = torch.where(seg == 3, 2, seg)
        elif name == "padded":
            w[C - 40:] = 0.0
            seg[C - 40:] = 0
        elif name == "nan_row":
            P[11, 5] = float("nan")
        return name, P, w, seg, E

    cases = [case("one_node", B, 5120, 1), case("own_node", B, 1024, B),
             case("nodes8", B, 5120, 8), case("nodes64", B, 5120, E0),
             case("empty_node", B, 4096, 8), case("padded", B, 4096, E0),
             case("nan_row", B, 4096, 8), case("n_not_mult4", B, 1001, E0),
             case("unaligned", B, 4096, E0, offset=1)]
    if cases[-1][1].data_ptr() % 16 == 0:
        raise AssertionError("the unaligned segmented case is aligned")
    worst = 0.0
    for name, P, w, seg, E in cases:
        out = fedavg_reduce.fedavg_reduce_leaves([P], w, seg, E)[0]
        again = fedavg_reduce.fedavg_reduce_leaves([P], w, seg, E)[0]
        plain = fedavg_reduce.segment_reduce_plain(P, w, seg, E)
        scale = fedavg_reduce.segment_reduce_plain(P.abs().nan_to_num(), w.abs(), seg, E)
        torch.cuda.synchronize()
        if not torch.equal(out.view(torch.int32), again.view(torch.int32)):
            raise AssertionError(f"K1 segmented launches differ bitwise: {name}")
        if not torch.equal(out.isnan(), plain.isnan()):
            raise AssertionError(f"K1 segmented NaNs differ from the plain version: {name}")
        err = (out - plain).abs().nan_to_num()
        if bool((err > K1_RTOL * scale + K1_ATOL).any()):
            raise AssertionError(f"K1 segmented route disagrees with its plain version: "
                                 f"{name}")
        worst = max(worst, float(err.max()))
        if name == "nan_row":
            rows = out.isnan().any(dim=1).tolist()
            if rows != [e == int(seg[11]) for e in range(E)]:
                raise AssertionError(f"K1 segmented route: the NaN left its segment: {rows}")
        if name == "empty_node" and not bool((out[3] == 0).all()):
            raise AssertionError("K1 segmented route: an empty segment is not 0")
    # async_hier's tier 0: the fedbuff delta stacks of the paper CNN's leaves
    stacks = [torch.randn((B, n), generator=gen, device="cuda") for n in leaves]
    w = torch.rand(B, generator=gen, device="cuda")
    seg = torch.sort(torch.randint(0, E0, (B,), generator=gen, device="cuda",
                                   dtype=torch.int32)).values
    run = lambda: fedavg_reduce.fedavg_reduce_leaves(stacks, w, seg, E0)  # noqa: E731
    before = fedavg_reduce.launches
    outs = run()
    tier0_launches = fedavg_reduce.launches - before
    for P, out in zip(stacks, outs):
        plain = fedavg_reduce.segment_reduce_plain(P, w, seg, E0)
        scale = fedavg_reduce.segment_reduce_plain(P.abs(), w, seg, E0)
        err = (out - plain).abs()
        if bool((err > K1_RTOL * scale + K1_ATOL).any()):
            raise AssertionError("K1 segmented route disagrees at async_hier's tier 0")
        worst = max(worst, float(err.max()))
    if tier0_launches != 1:
        raise AssertionError(f"K1 segmented: {tier0_launches} launches for the tree")
    onehot = [(torch.arange(E0, device="cuda")[:, None] == seg[None, :]).float() * w]
    numel = sum(leaves)
    timing = {
        "shape": [B, numel], "nodes": E0, "launches_per_call": tier0_launches,
        "ms": cuda_ms(torch, run, calls=20),
        "device_ms": device_ms(torch, run),
        "flat_ms": cuda_ms(torch, lambda: fedavg_reduce.fedavg_reduce_leaves(stacks, w),
                           calls=20),
        "flat_device_ms": device_ms(torch, lambda: fedavg_reduce.fedavg_reduce_leaves(
            stacks, w)),
        "plain_ms": cuda_ms(torch, lambda: [fedavg_reduce.segment_reduce_plain(
            P, w, seg, E0) for P in stacks], calls=5, trials=3, warmup=2),
        "library_ms": _mm_f32_ms(torch, onehot[0], stacks),
        # the stack read once, the (E, N) sums written once, w and seg read
        "bound_ms": (B * numel + E0 * numel + 2 * B) * 4 / HBM_BYTES_PER_S * 1e3,
        "flat_bound_ms": (B * numel + numel + B) * 4 / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library": "torch.mm of the (64, 256) one-hot weight matrix, f32 (TF32 off)",
    }
    return {"segmented_cases": [c[0] for c in cases], "segmented_max_abs_err": worst,
            "segmented_bitwise_repeat": True, "segmented_tier0": timing}


def _mm_f32_ms(torch, W, stacks):
    """``cuda_ms`` of ``torch.mm(W, P)`` over the stacks in full f32."""
    with _TF32(torch, {"cudnn": torch.backends.cudnn.allow_tf32, "matmul": False}):
        return cuda_ms(torch, lambda: [torch.mm(W, P) for P in stacks], calls=20)


def phase_sync_main(torch, fedavg_reduce):
    from repro_torch.core import load_metric
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch import fl_train

    args = fl_train.parse_args(SYNC_ARGV)
    t0 = time.time()
    task, engine = fl_train.build(args)
    setup_s = time.time() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fedavg_reduce.launches = 0
    res, state = _run_captured(engine, progress=True)
    launches = fedavg_reduce.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    fl_train.report(res, args)

    cfg = res.config
    off = [p for p, t in _state_tensors(state)
           if not (isinstance(t, torch.Tensor) and t.is_cuda)]
    if off:
        raise AssertionError(f"engine state off the GPU: {off}")
    n_leaves = len(tree_leaves(state["params"]))
    if launches != cfg.rounds:  # one grouped launch for the round's leaves
        raise AssertionError(f"K1 launched {launches} times in {cfg.rounds} rounds "
                             f"of {n_leaves} leaves")
    evals = [r.eval_loss for r in res.records]
    trains = [r.train_loss for r in res.records]
    if not all(map(math.isfinite, evals + trains)):
        raise AssertionError(f"non-finite losses: eval {evals} train {trains}")
    accs = [r.accuracy for r in res.records]
    if not accs[-1] > accs[0]:
        raise AssertionError(f"accuracy did not rise: {accs}")
    ls = res.load_stats
    target = cfg.n_clients / cfg.k
    mean_x = cfg.n_clients / ls["mean_cohort"]
    if abs(mean_x - target) > 0.15 * target:
        raise AssertionError(f"E[X] {mean_x} far from n/k = {target}")
    var_random = load_metric.random_selection_var(cfg.n_clients, cfg.k)
    if not ls["var_X"] < var_random:
        raise AssertionError(f"markov Var[X] {ls['var_X']} not below random {var_random}")
    out = {
        "phase": "sync_main", "ok": True, "argv": SYNC_ARGV,
        "kernel_launches": launches, "rounds": cfg.rounds, "param_leaves": n_leaves,
        "cohort_width": cfg.cohort_width(), "eval_every": cfg.eval_every,
        "rounds_per_s": cfg.rounds / res.wall_time_s,
        "wall_time_s": res.wall_time_s, "setup_s": setup_s,
        "eval_loss": evals[-1], "accuracy": accs[-1], "first_accuracy": accs[0],
        "mean_X": mean_x, "n_over_k": target, "mean_X_gaps": ls["mean_X"],
        "var_X": ls["var_X"], "x_samples": ls["num_samples"],
        "random_selection_var": var_random,
        "optimal_var": load_metric.optimal_var(cfg.n_clients, cfg.k, cfg.m),
        "mean_cohort": ls["mean_cohort"], "std_cohort": ls["std_cohort"],
        "peak_mem_gib": peak_gib,
        "tf32": {"cudnn": torch.backends.cudnn.allow_tf32,
                 "matmul": torch.backends.cuda.matmul.allow_tf32},
    }
    state, syncs = sync_free_steps(torch, engine, state, cfg.rounds)
    if syncs:
        raise AssertionError(f"a round synchronized with the host: {syncs}")
    out["host_syncs_in_2_rounds"] = 0
    steady = steady_and_profile(torch, engine, state, cfg.rounds + 2, res.wall_time_s,
                                steps=6, prof_steps=2, match="fedavg_reduce",
                                eval_every=cfg.eval_every)
    out.update({key.replace("_step", "_round"): val for key, val in steady.items()})
    emit(out)
    return launches


def _replay_sync(n, k, m, rounds, epochs, examples, shapes, width, seed=0):
    """Fixed numpy draws for every site of the calm sync path."""
    import numpy as np

    from repro_torch.core import load_metric

    rng = np.random.default_rng(seed)
    pi = load_metric.steady_state(load_metric.optimal_probs(n, k, m))
    init = {f"params/{name}": rng.standard_normal(shape).astype(np.float32)
            for name, shape in shapes.items()}
    init["policy_init"] = rng.choice(m + 1, size=n, p=pi)
    per_round = [{
        "select": rng.random(n, dtype=np.float32),
        "local_perm": np.argsort(rng.random((width, epochs, examples)), axis=-1),
    } for _ in range(rounds)]
    return init, per_round


def phase_sync_parity(torch, fedavg_reduce):
    from repro_torch.configs.paper_cnn import MNIST_CNN
    from repro_torch.core.draws import ReplayDraws
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.data.synthetic import load_dataset
    from repro_torch.engine import RunConfig, make_engine
    from repro_torch.engine.config import default_cohort_width
    from repro_torch.fl import make_cnn_task

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    n, k, m, rounds, epochs = 48, 8, 10, 6, 2
    width = default_cohort_width(n, k)
    train, test = load_dataset("mnist", seed=0, scale=0.02)
    s = MNIST_CNN.image_size // 4
    shapes = {"conv1": (5, 5, 1, 32), "conv2": (5, 5, 32, 64),
              "fc1": (s * s * 64, 512), "fc2": (512, 10)}
    cfg = RunConfig(mode="sync", n_clients=n, k=k, m=m, policy="markov",
                    rounds=rounds, local_epochs=epochs, batch_size=50, lr0=0.02,
                    seed=0)
    tasks = {dev: make_cnn_task(MNIST_CNN, train, test, n, seed=0, device=dev)
             for dev in ("cpu", "cuda")}
    init, per_round = _replay_sync(n, k, m, rounds, epochs,
                                   tasks["cpu"].examples_per_client, shapes, width)
    engines = {dev: make_engine(task, cfg, draws=ReplayDraws(init, per_round, dev))
               for dev, task in tasks.items()}
    states = {dev: eng.init() for dev, eng in engines.items()}
    before = fedavg_reduce.launches
    worst, selected = 0.0, 0
    for r in range(rounds):
        if r:  # each card round starts from the CPU's params of the round before
            states["cuda"]["params"] = tree_map(lambda t: t.cuda(), states["cpu"]["params"])
        auxs = {}
        for dev in ("cpu", "cuda"):
            states[dev], auxs[dev] = engines[dev].step(states[dev], r)
        a, b = states["cuda"], states["cpu"]
        same = (torch.equal(auxs["cuda"]["send"].cpu(), auxs["cpu"]["send"])
                and torch.equal(a["sched"]["ages"].cpu(), b["sched"]["ages"])
                and all(torch.equal(a["load_acc"][key].cpu(), val)
                        for key, val in b["load_acc"].items()))
        if not same:
            raise AssertionError(f"sync parity: round {r} discrete outputs differ")
        selected += int(auxs["cpu"]["send"].sum())
        for got, exp in zip(tree_leaves(a["params"]), tree_leaves(b["params"])):
            got = got.cpu()
            if not torch.allclose(got, exp, rtol=1e-4, atol=1e-5):
                raise AssertionError(f"sync parity: round {r} params differ")
            worst = max(worst, float((got - exp).abs().max()))
    launches = fedavg_reduce.launches - before
    if launches != rounds:  # one grouped launch a round
        raise AssertionError(f"sync parity: K1 launched {launches} times, "
                             f"expected {rounds}")
    emit({"phase": "sync_parity", "ok": True, "rounds": rounds, "width": width,
          "selected": selected,
          "kernel_launches": launches, "max_param_abs_diff_vs_cpu": worst,
          "tf32": False})


# --- slice C: the robustness tier -------------------------------------------

FAULT_N, FAULT_K, FAULT_STEPS = 48, 8, 4  # fault_contracts' small fleet
ENGINE_FAULTS = ("dropout", "straggler", "stale_replay", "corrupt", "sign_flip",
                 "scale_attack")
REPLAY_FAULTS = ("dropout", "straggler", "stale_replay", "corrupt", "sign_flip",
                 "collude")
SYNC_ATTACK_ROUNDS = 20
ATTACK = dict(faults=("scale_attack",), fault_rate=0.25,
              fault_kwargs={"scale_attack": {"factor": -3.0}})  # bench_faults.py
ATTACK_AGGREGATORS = (("fedavg", {}), ("trimmed_mean", {"trim": 0.35}),
                      ("coordinate_median", {}))
CHAOS_FLAGS = ["--faults", "dropout,corrupt,straggler,stale_replay", "--fault-rate",
               "0.1", "--robust-agg", "norm_clip"]
CHAOS_STEPS = 10
DEADLINE_STEPS = 3  # the deadline: this many steps of the calm run's clock


def _mismatches(torch, a, b):
    """Paths of the tensors of two engine states (or param trees) that are
    not bitwise equal (floats compared by their bits, so NaN equals the
    same NaN)."""
    ta, tb = dict(_state_tensors(a)), dict(_state_tensors(b))
    if ta.keys() != tb.keys():
        return sorted(set(ta) ^ set(tb))

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    return [p for p, t in ta.items()
            if not (t.dtype == tb[p].dtype and torch.equal(bits(t), bits(tb[p])))]


def _replay_faults(n, k, m, steps, epochs, examples, shapes, seed=1):
    """Fixed numpy draws for every site of the armed async path:
    ``_replay``'s calm sites plus the fault coins, the collude coalition
    and jitter, the corruption noise and the re-dispatch latencies."""
    import numpy as np

    init, per_step = _replay(n, k, m, steps, epochs, examples,
                             {path[:-2]: shape for path, shape in shapes.items()
                              if path.endswith("/w")}, seed)
    rng = np.random.default_rng(seed + 1)
    init["faults/collude/prone"] = rng.random(n, dtype=np.float32)
    for st in per_step:
        st["redispatch/latency_compute"] = rng.standard_normal(n).astype(np.float32)
        st["redispatch/latency_comm"] = rng.exponential(size=n).astype(np.float32)
        st["faults/straggler/hit"] = rng.random(n, dtype=np.float32)
        for name in REPLAY_FAULTS:
            if name != "straggler":
                st[f"faults/{name}/hit"] = rng.random(k, dtype=np.float32)
        st["faults/collude/jitter"] = rng.standard_normal(k).astype(np.float32)
        for path, shape in shapes.items():
            st[f"faults/noise/{path}"] = rng.standard_normal(
                (k,) + shape, dtype=np.float32)
    return init, per_step


def phase_fault_contracts(torch, fedavg_reduce):
    """The robustness tier's bitwise contracts on the card, cuDNN
    deterministic inside (restored after): rate-0 armed == calm (sync and
    async), armed run_chunk == per-step, crash-restart through
    ``checkpoint/store.py``, and one replayed armed async run equal to the
    CPU port's in every discrete output."""
    import tempfile

    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.configs.paper_cnn import MNIST_CNN
    from repro_torch.core.draws import ReplayDraws
    from repro_torch.core.tree import tree_paths
    from repro_torch.data.synthetic import load_dataset
    from repro_torch.engine import RunConfig, make_engine
    from repro_torch.fl import make_cnn_task
    from repro_torch.sim import events as ev_mod

    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        n, k, steps = FAULT_N, FAULT_K, FAULT_STEPS
        train, test = load_dataset("mnist", seed=0, scale=0.02)
        task = make_cnn_task(MNIST_CNN, train, test, n, seed=0, device="cuda")
        base = dict(n_clients=n, k=k, m=10, policy="markov", rounds=steps,
                    local_epochs=2, batch_size=50, lr0=0.02, seed=0)
        asyn = dict(base, mode="async", profile="lognormal")
        sync = dict(base, mode="sync")
        out = {"phase": "fault_contracts", "n": n, "k": k, "steps": steps,
               "cnn": "paper-cnn-mnist (full widths)", "cudnn_deterministic": True}

        # rate-0 armed == calm: send masks, losses, final params bitwise
        def lockstep(calm_kw, armed_kw):
            calm, armed = (make_engine(task, RunConfig(**calm_kw)),
                           make_engine(task, RunConfig(**armed_kw)))
            sc, sa = calm.init(), armed.init()
            same = True
            for r in range(steps):
                sc, ac = calm.step(sc, r)
                sa, aa = armed.step(sa, r)
                same &= torch.equal(ac["send"], aa["send"]) and torch.equal(
                    ac["loss"].nan_to_num(-1.0), aa["loss"].nan_to_num(-1.0))
            bad = _mismatches(torch, sc["params"], sa["params"])
            return same and not bad
        k1_before = fedavg_reduce.launches
        out["rate0_sync_equals_calm"] = lockstep(sync, dict(
            sync, faults=("dropout", "corrupt", "sign_flip", "scale_attack"),
            fault_rate=0.0))
        out["rate0_sync_k1_launches"] = fedavg_reduce.launches - k1_before
        out["rate0_async_equals_calm"] = lockstep(asyn, dict(
            asyn, faults=ENGINE_FAULTS, fault_rate=0.0, redispatch_timeout=1e9))

        # armed at rate 0.5: run_chunk == per-step, the whole state
        armed_kw = dict(asyn, faults=ENGINE_FAULTS, fault_rate=0.5,
                        redispatch_timeout=2.0, aggregator="norm_clip")
        per_step = make_engine(task, RunConfig(**armed_kw))
        st = per_step.init()
        for r in range(steps):
            st, _ = per_step.step(st, r)
        chunked = make_engine(task, RunConfig(**armed_kw))
        sc, _ = chunked.run_chunk(chunked.init(), 0, steps, False)
        out["armed_chunk_equals_per_step"] = not _mismatches(torch, st, sc)
        out["armed_injected"] = {nm: float(f["injected"]) for nm, f in st["faults"].items()}

        # crash-restart: 3 steps, checkpoint, a fresh engine resumes for 3
        crash_kw = dict(asyn, rounds=6, faults=("dropout", "corrupt"), fault_rate=0.5,
                        redispatch_timeout=2.0, aggregator="norm_clip")
        full_eng = make_engine(task, RunConfig(**crash_kw))
        full, _ = full_eng.run_chunk(full_eng.init(), 0, 6, False)
        crashed = make_engine(task, RunConfig(**crash_kw))
        half, _ = crashed.run_chunk(crashed.init(), 0, 3, False)
        with tempfile.TemporaryDirectory() as d:
            tree = {"state": half, "draws": crashed.draws.get_state()}
            save_checkpoint(d, tree, step=3)
            restored, step = load_checkpoint(d, tree)
        restarted = make_engine(task, RunConfig(**crash_kw))
        restarted.draws.set_state(restored["draws"])
        resumed, _ = restarted.run_chunk(restored["state"], step, 3, False)
        out["crash_restart_bitwise"] = not _mismatches(torch, full, resumed)

        # one replayed armed run: the card's discrete outputs equal the CPU's
        shapes = {p: tuple(t.shape) for p, t in tree_paths(full["params"])}
        replay_kw = dict(asyn, faults=REPLAY_FAULTS, fault_rate=0.5,
                         redispatch_timeout=2.0, aggregator="norm_clip")
        tasks = {"cuda": task,
                 "cpu": make_cnn_task(MNIST_CNN, train, test, n, seed=0, device="cpu")}
        init, per_step_draws = _replay_faults(n, k, 10, steps, 2,
                                              task.examples_per_client, shapes)
        traces = {}
        for dev, tk in tasks.items():
            engine = make_engine(tk, RunConfig(**replay_kw),
                                 draws=ReplayDraws(init, per_step_draws, dev))
            pops, orig = [], ev_mod.pop_events

            def recording(ev, kk, *, use_kernel=None):
                res = orig(ev, kk, use_kernel=use_kernel)
                pops.append((res[1].cpu(), res[2].cpu()))
                return res

            ev_mod.pop_events = recording
            try:
                state, trace = engine.init(), []
                for r in range(steps):
                    state, aux = engine.step(state, r)
                    trace.append({
                        "send": aux["send"].cpu(), "ages": state["sched"]["ages"].cpu(),
                        "version": int(state["version"]), "clock": float(state["clock"]),
                        "retries": state["rd"]["retries"].cpu(),
                        "t_disp": state["rd"]["t_disp"].cpu(),
                        "faults": {f"{nm}.{key}": f[key].cpu() for nm, f in
                                   state["faults"].items()
                                   for key in ("prone", "injected", "exposed")},
                        "counters": {key: float(v) for key, v in state["stats"].items()
                                     if key in ("redispatched", "rd_expired", "updates",
                                                "aggs", "stale_max")},
                    })
            finally:
                ev_mod.pop_events = orig
            traces[dev] = (trace, pops)
        worst = 0.0
        for r in range(steps):
            (a, (ai, av)), (b, (bi, bv)) = [(t[0][r], t[1][r]) for t in
                                            (traces["cuda"], traces["cpu"])]
            same = (torch.equal(a["send"], b["send"]) and torch.equal(ai, bi)
                    and torch.equal(av, bv) and torch.equal(a["ages"], b["ages"])
                    and a["version"] == b["version"]
                    and torch.equal(a["retries"], b["retries"])
                    and all(torch.equal(v, b["faults"][key])
                            for key, v in a["faults"].items())
                    and a["counters"] == b["counters"])
            if not same:
                raise AssertionError(f"fault_contracts: replay step {r} discrete "
                                     "outputs differ between the card and the CPU")
            if abs(a["clock"] - b["clock"]) > 1e-6 * abs(b["clock"]) or not torch.allclose(
                    a["t_disp"], b["t_disp"], rtol=1e-6):
                raise AssertionError(f"fault_contracts: replay step {r} clock differs")
            worst = max(worst, abs(a["clock"] - b["clock"]))
        last = traces["cpu"][0][-1]
        out["replay_card_equals_cpu"] = True
        out["replay_counters"] = last["counters"]
        out["replay_injected"] = {key: float(v) for key, v in last["faults"].items()
                                  if key.endswith(".injected")}
        out["replay_max_clock_diff"] = worst
        if not (last["counters"]["rd_expired"] > 0
                and all(v > 0 for v in out["replay_injected"].values())):
            raise AssertionError(f"fault_contracts: the replayed run is degenerate: {last}")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    failed = [key for key in ("rate0_sync_equals_calm", "rate0_async_equals_calm",
                              "armed_chunk_equals_per_step", "crash_restart_bitwise")
              if not out[key]]
    if failed:
        raise AssertionError(f"fault_contracts: {failed} do not hold bitwise")
    if out["rate0_sync_k1_launches"] != 2 * steps:  # calm and armed, one a round
        raise AssertionError(f"fault_contracts: K1 launched "
                             f"{out['rate0_sync_k1_launches']} times in 2 x {steps} rounds")
    emit({**out, "ok": True})


class _TF32:
    """Inside the block, TF32 as ``tf32`` says (``{"cudnn": .., "matmul":
    ..}``, as ``main`` reports its own), restored after: the parity phases
    turn TF32 off for the rest of the script, and a phase timed beside
    ``main`` or ``sync_main`` must run the same math."""

    def __init__(self, torch, tf32):
        self.torch, self.tf32 = torch, tf32

    def __enter__(self):
        b = self.torch.backends
        self.saved = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32)
        b.cudnn.allow_tf32 = self.tf32["cudnn"]
        b.cuda.matmul.allow_tf32 = self.tf32["matmul"]

    def __exit__(self, *exc):
        b = self.torch.backends
        b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32 = self.saved


def phase_sync_attack(torch, fedavg_reduce, tf32):
    """``benchmarks/bench_faults.py`` part (b) at the paper's widths and the
    sync main path's settings: a model-replacement attack (scale_attack
    x -3 on 25% of slots) under fedavg, trimmed_mean (trim 0.35) and
    coordinate_median, with TF32 as ``sync_main`` ran it. Returns each
    aggregator's row."""
    with _TF32(torch, tf32):
        return _sync_attack(torch, fedavg_reduce, tf32)


def _sync_attack(torch, fedavg_reduce, tf32):
    import dataclasses

    from repro_torch.engine import make_engine
    from repro_torch.launch import fl_train
    from repro_torch.launch._fl_cli import build_run_config, build_task

    argv = SYNC_ARGV[:-1] + [str(SYNC_ATTACK_ROUNDS)]
    args = fl_train.parse_args(argv)
    task = build_task(args)
    rows = {}
    for name, kwargs in ATTACK_AGGREGATORS:
        cfg = dataclasses.replace(build_run_config(args, mode="sync", eval_div=30),
                                  aggregator=name, aggregator_kwargs=kwargs, **ATTACK)
        engine = make_engine(task, cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fedavg_reduce.launches = 0
        res, state = _run_captured(engine)
        launches = fedavg_reduce.launches
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        steady, _ = _steady_ms(torch, engine, state, cfg.rounds, 4, cfg.eval_every)
        last = res.records[-1]
        rows[name] = {
            "rounds_per_s": cfg.rounds / res.wall_time_s, "steady_ms_per_round": steady,
            "eval_loss": last.eval_loss, "accuracy": last.accuracy,
            "first_eval_loss": res.records[0].eval_loss,
            "injected": res.load_stats["fault_scale_attack_injected"],
            "k1_launches": launches, "peak_mem_gib": peak_gib,
            **{f"agg_{s}": res.load_stats[f"agg_{s}"]
               for s in engine.aggregator.stat_names},
        }
        print(f"  sync_attack {name}: eval_loss={last.eval_loss:.4f} "
              f"acc={last.accuracy:.4f} injected={rows[name]['injected']:.0f}", flush=True)
    fed = rows["fedavg"]["eval_loss"]
    for name in ("trimmed_mean", "coordinate_median"):
        loss = rows[name]["eval_loss"]
        if not (math.isfinite(loss) and (not math.isfinite(fed) or loss < fed)):
            raise AssertionError(f"sync_attack: {name} does not recover: eval loss "
                                 f"{loss} vs fedavg {fed}")
    expect = {"fedavg": SYNC_ATTACK_ROUNDS, "trimmed_mean": 0, "coordinate_median": 0}
    if {name: row["k1_launches"] for name, row in rows.items()} != expect:
        raise AssertionError(f"sync_attack: K1 launches {rows} != {expect}")
    if not all(row["injected"] > 0 for row in rows.values()):
        raise AssertionError("sync_attack: the attack never hit")
    emit({"phase": "sync_attack", "ok": True, "argv": argv, "attack": ATTACK,
          "rounds": SYNC_ATTACK_ROUNDS, "tf32": tf32, "aggregators": rows})
    return rows


def _order_stat_ms(torch, name, kwargs, C, params):
    """One accumulate plus finalize of an order-statistic aggregator over a
    (C, params) f32 cohort stack (all slots valid), beside the bytes bound
    of one read of the stack."""
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.engine.registry import make_aggregator

    agg = make_aggregator(name, **kwargs)
    gen = torch.Generator(device="cuda").manual_seed(5)
    g = tree_map(lambda p: torch.randn(p.shape, generator=gen, device="cuda"), params)
    upd = tree_map(lambda p: torch.randn((C,) + tuple(p.shape), generator=gen,
                                         device="cuda"), params)
    w = torch.ones(C, device="cuda")

    def run():
        return agg.finalize(g, agg.accumulate(agg.init(g), upd, g, w))

    numel = sum(u.numel() for u in tree_leaves(upd))
    return {"aggregator": name, "C": C, "numel": numel,
            "ms": cuda_ms(torch, run, calls=3, trials=3, warmup=2),
            "bound_ms": numel * 4 / HBM_BYTES_PER_S * 1e3}


def phase_async_chaos(torch, event_topk, fedavg_reduce, calm):
    """``main``'s configuration with the chaos stack armed: dropout,
    corrupt, straggler and stale_replay at rate 0.1, ``norm_clip``, and a
    re-dispatch deadline of DEADLINE_STEPS steps of the calm run's clock;
    the step time beside ``main``'s (bench_faults.py part (a)), with TF32 as
    ``main`` ran it; then the order-statistic aggregators timed at the
    fleet and sync widths."""
    with _TF32(torch, calm["tf32"]):
        _async_chaos(torch, event_topk, fedavg_reduce, calm)


def _async_chaos(torch, event_topk, fedavg_reduce, calm):
    from repro_torch.engine.config import default_cohort_width
    from repro_torch.launch import fl_async

    deadline = DEADLINE_STEPS * calm["clock_per_step"]
    argv = (MAIN_ARGV[:-1] + [str(CHAOS_STEPS)] + CHAOS_FLAGS
            + ["--redispatch-timeout", f"{deadline:.6g}"])
    args = fl_async.parse_args(argv)
    t0 = time.time()
    task, engine = fl_async.build(args)
    setup_s = time.time() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    event_topk.launches = fedavg_reduce.launches = 0
    res, state = _run_captured(engine, progress=True)
    k2, k1 = event_topk.launches, fedavg_reduce.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    fl_async.report(res, args)
    cfg, ls = res.config, res.load_stats
    if (k2, k1) != (cfg.rounds, cfg.rounds):
        raise AssertionError(f"async_chaos: K2 {k2} and K1 {k1} launches in "
                             f"{cfg.rounds} steps, expected one each a step")
    counters = {key: ls[key] for key in ls
                if key.startswith("fault_") or key in ("rd_expired", "redispatched")}
    if len(counters) != 6 or not all(v > 0 for v in counters.values()):
        raise AssertionError(f"async_chaos: a counter stayed at zero: {counters}")
    if not math.isfinite(res.records[-1].eval_loss):
        raise AssertionError(f"async_chaos: eval loss {res.records[-1].eval_loss}")
    state, syncs = sync_free_steps(torch, engine, state, cfg.rounds)
    if syncs:
        raise AssertionError(f"async_chaos: a step synchronized with the host: {syncs}")
    out = {"phase": "async_chaos", "ok": True, "argv": argv, "tf32": calm["tf32"],
           "deadline_s": deadline, "calm_clock_per_step": calm["clock_per_step"],
           "k2_launches": k2, "k1_launches": k1, "steps": cfg.rounds,
           "steps_per_s": cfg.rounds / res.wall_time_s, "setup_s": setup_s,
           "eval_loss": res.records[-1].eval_loss, "accuracy": res.records[-1].accuracy,
           "counters": counters, "agg_clipped": ls["agg_clipped"],
           "sim_time": res.wall_stats["sim_time"], "peak_mem_gib": peak_gib,
           "host_syncs_in_2_steps": 0}
    out.update(steady_and_profile(torch, engine, state, cfg.rounds + 2,
                                  res.wall_time_s, match="fedavg_reduce"))
    out["main_steady_ms_per_step"] = calm["steady_ms_per_step"]
    out["chaos_over_main"] = out["steady_ms_per_step"] / calm["steady_ms_per_step"]
    params = engine.eval_params(state)
    del state, engine
    torch.cuda.empty_cache()
    out["order_stats"] = [
        _order_stat_ms(torch, name, kwargs, C, params)
        for C in (cfg.resolved_buffer_size(), default_cohort_width(100, 15))
        for name, kwargs in ATTACK_AGGREGATORS[1:]]
    emit(out)


# --- slice D: aggregation topologies -----------------------------------------

HIER_FLAGS = ["--topology", "hierarchical", "--tiers", "64,8"]
SYNC_HIER_FLAGS = ["--topology", "hierarchical", "--tiers", "10,2"]
SYNC_HIER_ROUNDS = 20
TOPO_STEPS = 4  # topo_contracts' steps (6 for the crash-restart)
TOPO_HB = 5.0  # topo_contracts' heartbeat: about the median latency with 3 hops
TOPO_KW = {"tiers": (4, 2), "heartbeat_timeout": TOPO_HB}


def _replay_hops(per_step, n, tiers, seed=2):
    """The hop sites of a hierarchy over ``tiers`` added to each step's
    replayed draws: ``hop/0`` per client, ``hop/<i>`` per tier-(i-1) node."""
    import numpy as np

    rng = np.random.default_rng(seed)
    for st in per_step:
        for i, size in enumerate((n,) + tuple(tiers)):
            st[f"hop/{i}/latency_compute"] = rng.standard_normal(size).astype(np.float32)
            st[f"hop/{i}/latency_comm"] = rng.exponential(size=size).astype(np.float32)
    return per_step


def phase_topo_contracts(torch, fedavg_reduce):
    """Slice D's bitwise contracts on the card, cuDNN deterministic inside
    (restored after): a star equals no topology (sync and async), a tiered
    ``run_chunk`` equals its steps, crash-restart under a hierarchy with a
    heartbeat, and one replayed tiered async run equal to the CPU port's in
    every discrete output."""
    import tempfile

    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.configs.paper_cnn import MNIST_CNN
    from repro_torch.core.draws import ReplayDraws
    from repro_torch.core.tree import tree_paths
    from repro_torch.data.synthetic import load_dataset
    from repro_torch.engine import RunConfig, make_engine
    from repro_torch.fl import make_cnn_task
    from repro_torch.sim import events as ev_mod

    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        n, k, steps = FAULT_N, FAULT_K, TOPO_STEPS
        train, test = load_dataset("mnist", seed=0, scale=0.02)
        task = make_cnn_task(MNIST_CNN, train, test, n, seed=0, device="cuda")
        base = dict(n_clients=n, k=k, m=10, policy="markov", rounds=steps,
                    local_epochs=2, batch_size=50, lr0=0.02, seed=0)
        asyn = dict(base, mode="async", profile="lognormal")
        sync = dict(base, mode="sync")
        hier = dict(topology="hierarchical", topology_kwargs=TOPO_KW)
        out = {"phase": "topo_contracts", "n": n, "k": k, "steps": steps,
               "topology": RunConfig(**asyn, **hier).topology_name(),
               "cnn": "paper-cnn-mnist (full widths)", "cudnn_deterministic": True}

        def lockstep(kw_a, kw_b):
            """Two engines stepped side by side: send masks, losses and the
            final state bitwise."""
            ea, eb = make_engine(task, RunConfig(**kw_a)), make_engine(task, RunConfig(**kw_b))
            sa, sb = ea.init(), eb.init()
            same = True
            for r in range(steps):
                sa, aa = ea.step(sa, r)
                sb, ab = eb.step(sb, r)
                same &= torch.equal(aa["send"], ab["send"]) and torch.equal(
                    aa["loss"].nan_to_num(-1.0), ab["loss"].nan_to_num(-1.0))
            return same and not _mismatches(torch, sa, sb)

        out["star_equals_none_sync"] = lockstep(sync, dict(sync, topology="star"))
        out["star_equals_none_async"] = lockstep(asyn, dict(asyn, topology="star"))

        def chunk_vs_steps(kw):
            per_step = make_engine(task, RunConfig(**kw))
            st = per_step.init()
            for r in range(steps):
                st, _ = per_step.step(st, r)
            chunked = make_engine(task, RunConfig(**kw))
            sc, _ = chunked.run_chunk(chunked.init(), 0, steps, False)
            return st, not _mismatches(torch, st, sc)

        k1_before = fedavg_reduce.launches
        _, out["tiered_chunk_equals_per_step_sync"] = chunk_vs_steps(
            dict(sync, topology="hierarchical", topology_kwargs={"tiers": (4, 2)}))
        out["tiered_sync_k1_launches"] = fedavg_reduce.launches - k1_before
        st, out["tiered_chunk_equals_per_step_async"] = chunk_vs_steps(
            dict(asyn, aggregator="norm_clip", **hier))
        out["tiered_async_hb_expired"] = float(st["stats"]["hb_expired"])

        # crash-restart: 3 steps, checkpoint, a fresh engine resumes for 3
        crash_kw = dict(asyn, rounds=6, redispatch_timeout=2.0, **hier)
        full_eng = make_engine(task, RunConfig(**crash_kw))
        full, _ = full_eng.run_chunk(full_eng.init(), 0, 6, False)
        crashed = make_engine(task, RunConfig(**crash_kw))
        half, _ = crashed.run_chunk(crashed.init(), 0, 3, False)
        with tempfile.TemporaryDirectory() as d:
            tree = {"state": half, "draws": crashed.draws.get_state()}
            save_checkpoint(d, tree, step=3)
            restored, step = load_checkpoint(d, tree)
        restarted = make_engine(task, RunConfig(**crash_kw))
        restarted.draws.set_state(restored["draws"])
        resumed, _ = restarted.run_chunk(restored["state"], step, 3, False)
        out["crash_restart_bitwise"] = not _mismatches(torch, full, resumed)

        # one replayed tiered run: the card's discrete outputs equal the CPU's
        shapes = {p[:-2]: tuple(t.shape) for p, t in tree_paths(full["params"])
                  if p.endswith("/w")}
        tasks = {"cuda": task,
                 "cpu": make_cnn_task(MNIST_CNN, train, test, n, seed=0, device="cpu")}
        init, per_step_draws = _replay(n, k, 10, steps, 2, task.examples_per_client,
                                       shapes)
        per_step_draws = _replay_hops(per_step_draws, n, TOPO_KW["tiers"])
        traces = {}
        for dev, tk in tasks.items():
            engine = make_engine(tk, RunConfig(**asyn, **hier),
                                 draws=ReplayDraws(init, per_step_draws, dev))
            pops, orig = [], ev_mod.pop_events

            def recording(ev, kk, *, use_kernel=None):
                res = orig(ev, kk, use_kernel=use_kernel)
                pops.append((res[1].cpu(), res[2].cpu()))
                return res

            ev_mod.pop_events = recording
            try:
                state, trace = engine.init(), []
                for r in range(steps):
                    state, aux = engine.step(state, r)
                    trace.append({
                        "send": aux["send"].cpu(), "ages": state["sched"]["ages"].cpu(),
                        "version": int(state["version"]), "clock": float(state["clock"]),
                        "tier_acc": {key: v.cpu() for key, v in state["tier_acc"].items()},
                        "last_beat": state["hb"]["last_beat"].cpu(),
                        "counters": {key: float(v) for key, v in state["stats"].items()
                                     if key in ("hb_expired", "updates", "aggs",
                                                "stale_max", "stale_cnt")},
                    })
            finally:
                ev_mod.pop_events = orig
            traces[dev] = (trace, pops)
        worst = 0.0
        for r in range(steps):
            (a, (ai, av)), (b, (bi, bv)) = [(t[0][r], t[1][r]) for t in
                                            (traces["cuda"], traces["cpu"])]
            same = (torch.equal(a["send"], b["send"]) and torch.equal(ai, bi)
                    and torch.equal(av, bv) and torch.equal(a["ages"], b["ages"])
                    and a["version"] == b["version"] and a["counters"] == b["counters"]
                    and all(torch.equal(v, b["tier_acc"][key])
                            for key, v in a["tier_acc"].items()))
            if not same:
                raise AssertionError(f"topo_contracts: replay step {r} discrete "
                                     "outputs differ between the card and the CPU")
            if abs(a["clock"] - b["clock"]) > 1e-6 * abs(b["clock"]) or not torch.allclose(
                    a["last_beat"], b["last_beat"], rtol=1e-6):
                raise AssertionError(f"topo_contracts: replay step {r} clock differs")
            worst = max(worst, abs(a["clock"] - b["clock"]))
        last = traces["cpu"][0][-1]
        out["replay_card_equals_cpu"] = True
        out["replay_counters"] = last["counters"]
        out["replay_max_clock_diff"] = worst
        if not (last["counters"]["hb_expired"] > 0 and last["counters"]["updates"] > 0):
            raise AssertionError(f"topo_contracts: the replayed run is degenerate: {last}")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    failed = [key for key in ("star_equals_none_sync", "star_equals_none_async",
                              "tiered_chunk_equals_per_step_sync",
                              "tiered_chunk_equals_per_step_async",
                              "crash_restart_bitwise") if not out[key]]
    if failed:
        raise AssertionError(f"topo_contracts: {failed} do not hold bitwise")
    if out["tiered_sync_k1_launches"] != 2 * 2 * steps:  # 2 engines, tiers 0 and 1
        raise AssertionError(f"topo_contracts: K1 launched "
                             f"{out['tiered_sync_k1_launches']} times in 2 x {steps} "
                             "tiered rounds, expected two a round")
    emit({**out, "ok": True})


def phase_async_hier(torch, event_topk, fedavg_reduce, calm):
    """``main``'s configuration under ``--topology hierarchical --tiers
    64,8`` and a heartbeat of DEADLINE_STEPS steps of ``main``'s simulated
    clock, 20 steps, with TF32 as ``main`` ran it."""
    with _TF32(torch, calm["tf32"]):
        return _async_hier(torch, event_topk, fedavg_reduce, calm)


def _async_hier(torch, event_topk, fedavg_reduce, calm):
    from repro_torch.launch import fl_async

    timeout = DEADLINE_STEPS * calm["clock_per_step"]
    argv = MAIN_ARGV + HIER_FLAGS + ["--heartbeat-timeout", f"{timeout:.6g}"]
    args = fl_async.parse_args(argv)
    t0 = time.time()
    task, engine = fl_async.build(args)
    setup_s = time.time() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    event_topk.launches = fedavg_reduce.launches = 0
    res, state = _run_captured(engine, progress=True)
    k2, k1 = event_topk.launches, fedavg_reduce.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    fl_async.report(res, args)
    cfg, ls, ws = res.config, res.load_stats, res.wall_stats
    topo = cfg.resolved_topology()
    if (k2, k1) != (cfg.rounds, 2 * cfg.rounds):
        raise AssertionError(f"async_hier: K2 {k2} and K1 {k1} launches in {cfg.rounds} "
                             "steps, expected one K2 and two K1 (tiers 0 and 1) a step")
    off = [p for p, t in _state_tensors(state)
           if not (isinstance(t, torch.Tensor) and t.is_cuda)]
    if off:
        raise AssertionError(f"async_hier: engine state off the GPU: {off}")
    tiers = {key: ls[key] for key in ("tier_num_samples", "tier_mean_X", "tier_var_X")}
    if any(len(v) != topo.tier_sizes[0] for v in tiers.values()):
        raise AssertionError(f"async_hier: tier entries {tiers}")
    if not 0 < sum(tiers["tier_num_samples"]) == ls["num_samples"]:
        raise AssertionError(f"async_hier: tier samples {sum(tiers['tier_num_samples'])} "
                             f"vs the run's {ls['num_samples']}")
    if not ws["hb_expired"] > 0:
        raise AssertionError(f"async_hier: the heartbeat ({timeout} s) never fired")
    evals = [r.eval_loss for r in res.records]
    if not all(map(math.isfinite, evals)) or not ws["updates_applied"] > 0:
        raise AssertionError(f"async_hier: eval losses {evals}, "
                             f"{ws['updates_applied']} updates")
    state, syncs = sync_free_steps(torch, engine, state, cfg.rounds)
    if syncs:
        raise AssertionError(f"async_hier: a step synchronized with the host: {syncs}")
    out = {"phase": "async_hier", "ok": True, "argv": argv, "tf32": calm["tf32"],
           "topology": cfg.topology_name(), "heartbeat_timeout_s": timeout,
           "calm_clock_per_step": calm["clock_per_step"],
           "k2_launches": k2, "k1_launches": k1, "steps": cfg.rounds,
           "steps_per_s": cfg.rounds / res.wall_time_s, "setup_s": setup_s,
           "eval_loss": evals[-1], "accuracy": res.records[-1].accuracy,
           "hb_expired": ws["hb_expired"], "updates_applied": ws["updates_applied"],
           "sim_time": ws["sim_time"], "main_sim_time": 20 * calm["clock_per_step"],
           "num_samples": ls["num_samples"], **tiers,
           "tier_nodes_without_samples": sum(c == 0 for c in tiers["tier_num_samples"]),
           "peak_mem_gib": peak_gib, "host_syncs_in_2_steps": 0}
    out.update(steady_and_profile(torch, engine, state, cfg.rounds + 2,
                                  res.wall_time_s, match="fedavg_reduce"))
    out["main_steady_ms_per_step"] = calm["steady_ms_per_step"]
    out["hier_over_main"] = out["steady_ms_per_step"] / calm["steady_ms_per_step"]
    emit(out)
    return k1


def phase_sync_hier(torch, fedavg_reduce, tf32):
    """``sync_main`` under ``--topology hierarchical --tiers 10,2``,
    SYNC_HIER_ROUNDS rounds, with TF32 as ``sync_main`` ran it."""
    with _TF32(torch, tf32):
        return _sync_hier(torch, fedavg_reduce, tf32)


def _sync_hier(torch, fedavg_reduce, tf32):
    from repro_torch.launch import fl_train

    argv = SYNC_ARGV[:-1] + [str(SYNC_HIER_ROUNDS)] + SYNC_HIER_FLAGS
    args = fl_train.parse_args(argv)
    t0 = time.time()
    task, engine = fl_train.build(args)
    setup_s = time.time() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fedavg_reduce.launches = 0
    res, state = _run_captured(engine, progress=True)
    launches = fedavg_reduce.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    fl_train.report(res, args)
    cfg, ls = res.config, res.load_stats
    if launches != 2 * cfg.rounds:
        raise AssertionError(f"sync_hier: K1 launched {launches} times in {cfg.rounds} "
                             "rounds, expected two a round (tiers 0 and 1)")
    accs = [r.accuracy for r in res.records]
    evals = [r.eval_loss for r in res.records]
    if not (all(map(math.isfinite, evals)) and accs[-1] > accs[0]
            and evals[-1] < evals[0]):
        raise AssertionError(f"sync_hier: did not learn: accuracy {accs}, eval {evals}")
    if len(ls["tier_var_X"]) != 10 or sum(ls["tier_num_samples"]) != ls["num_samples"]:
        raise AssertionError(f"sync_hier: tier stats {ls}")
    state, syncs = sync_free_steps(torch, engine, state, cfg.rounds)
    if syncs:
        raise AssertionError(f"sync_hier: a round synchronized with the host: {syncs}")
    steady, _ = _steady_ms(torch, engine, state, cfg.rounds + 2, 4, cfg.eval_every)
    emit({"phase": "sync_hier", "ok": True, "argv": argv, "tf32": tf32,
          "topology": cfg.topology_name(), "rounds": cfg.rounds,
          "kernel_launches": launches, "rounds_per_s": cfg.rounds / res.wall_time_s,
          "steady_ms_per_round": steady, "setup_s": setup_s,
          "eval_loss": evals[-1], "first_eval_loss": evals[0], "accuracy": accs[-1],
          "first_accuracy": accs[0], "var_X": ls["var_X"], "x_samples": ls["num_samples"],
          "tier_var_X": ls["tier_var_X"], "tier_num_samples": ls["tier_num_samples"],
          "peak_mem_gib": peak_gib, "host_syncs_in_2_rounds": 0})
    return launches


# --- slice E: adaptive defense -------------------------------------------------

DEF_STEPS = 4  # defense_contracts' steps (6 for the crash-restart)
# tests/test_defense.py's ARMED: a low threshold and a short mtd window, so
# a few steps quarantine and move the ladder
DEF_ARMED = {"threshold": 0.3, "mtd": True, "mtd_window": 2, "mtd_up": 0.05,
             "mtd_down": 0.01}
DEF_ATTACK = dict(faults=("scale_attack",), fault_rate=1.0,
                  fault_kwargs={"scale_attack": {"factor": -3.0, "client_frac": 0.25}})
COLLUDE_ATTACK = dict(faults=("collude",), fault_rate=1.0,
                      fault_kwargs={"collude": {"client_frac": 0.25, "jitter": 0.1}})
# tests/test_collusion.py's ARMED: collusion sketches and the learned head
# fed the exposure labels
DEF_COLLUSION = dict(defense=True, defense_kwargs={"threshold": 0.3, "collusion": True,
                                                   "detector": "learned",
                                                   "clique_min_obs": 2},
                     fault_exposure=True, **COLLUDE_ATTACK)
ASYNC_DEFENSE_STEPS = 10
ASYNC_DEFENSE_FLAGS = ["--faults", "scale_attack", "--fault-rate", "1", "--defense",
                       "--collusion", "--quarantine-threshold", "0.55"]
SYNC_DEFENSE_ROUNDS = 20
# benchmarks/bench_defense.py's pinned knobs
BENCH_DEFENSE = {"threshold": 0.55, "ewma": 0.5}
BENCH_MTD = {"mtd": True, "mtd_window": 4, "mtd_trims": (0.0, 0.15, 0.25, 0.35),
             "mtd_up": 0.1, "mtd_down": 0.02}
BENCH_COLLUSION = {**BENCH_DEFENSE, "collusion": True, "clique_min_obs": 2,
                   "q_decay": 1.0, "threshold": 0.60}
FAMILIES = ("base", "trimmed_mean", "coordinate_median", "norm_clip")


def _detection(res, fault):
    """Recall and false-positive rate of the final suspects (status != 0)
    against the run's fault exposure."""
    import numpy as np

    hit = res.fault_exposure[fault] > 0
    flagged = res.defense["status"] != 0
    return {"exposed": int(hit.sum()), "flagged": int(flagged.sum()),
            "flagged_exposed": int((flagged & hit).sum()),
            "recall": float((flagged & hit).sum() / max(int(hit.sum()), 1)),
            "fpr": float((flagged & ~hit).sum() / max(int((~hit).sum()), 1)),
            "rep_exposed_mean": float(np.mean(res.defense["reputation"][hit]))
            if hit.any() else None}


def _def_counters(load_stats):
    return {key: v for key, v in load_stats.items() if key.startswith("def_")}


def phase_defense_contracts(torch, fedavg_reduce):
    """Slice E's bitwise contracts on the card, TF32 off and cuDNN
    deterministic inside (both restored after): defense off adds no state
    and no sub-stream; ``threshold=inf`` with mtd armed equals the calm run
    (both engines, per step and chunked); the ARMED run and the collusion +
    learned + exposure run give ``run_chunk`` == per-step in both engines;
    a crash-restart of an armed mtd + collusion run; a replayed armed run
    equal to the CPU port's in every discrete output; and the host-read
    rule (one read of the mtd level per closed window, none otherwise)."""
    with _TF32(torch, {"cudnn": False, "matmul": False}):
        return _defense_contracts(torch, fedavg_reduce)


def _defense_contracts(torch, fedavg_reduce):
    import tempfile

    import numpy as np

    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.configs.paper_cnn import MNIST_CNN
    from repro_torch.core.draws import ReplayDraws
    from repro_torch.core.tree import tree_paths
    from repro_torch.data.synthetic import load_dataset
    from repro_torch.engine import RunConfig, make_engine
    from repro_torch.fl import make_cnn_task
    from repro_torch.sim import events as ev_mod

    t_start = time.time()
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    k1_before = fedavg_reduce.launches
    try:
        n, k, steps = FAULT_N, FAULT_K, DEF_STEPS
        train, test = load_dataset("mnist", seed=0, scale=0.02)
        task = make_cnn_task(MNIST_CNN, train, test, n, seed=0, device="cuda")
        base = dict(n_clients=n, k=k, m=10, policy="markov", rounds=steps,
                    local_epochs=2, batch_size=50, lr0=0.02, seed=0)
        asyn = dict(base, mode="async", profile="lognormal")
        sync = dict(base, mode="sync")
        armed = dict(defense=True, defense_kwargs=DEF_ARMED, **DEF_ATTACK)
        out = {"phase": "defense_contracts", "n": n, "k": k, "steps": steps,
               "cnn": "paper-cnn-mnist (full widths)", "cudnn_deterministic": True,
               "tf32": False}

        # defense off: no state key and no sub-stream
        eng = make_engine(task, RunConfig(**asyn))
        st, _ = eng.step(eng.init(), 0)
        out["off_adds_no_state"] = ("defense" not in st
                                    and list(eng.draws.get_state()) == [""])

        # threshold=inf with mtd armed == calm: per step, and chunked
        def inf_equals_calm(kw):
            inf_kw = dict(kw, defense=True, defense_kwargs={
                "threshold": math.inf, "mtd": True, "mtd_window": 2})
            calm, arm = make_engine(task, RunConfig(**kw)), make_engine(task, RunConfig(**inf_kw))
            sc, sa = calm.init(), arm.init()
            same = True
            for r in range(steps):
                sc, ac = calm.step(sc, r)
                sa, aa = arm.step(sa, r)
                same &= torch.equal(ac["send"], aa["send"]) and torch.equal(
                    ac["loss"].nan_to_num(-1.0), aa["loss"].nan_to_num(-1.0))
            chunk = make_engine(task, RunConfig(**inf_kw))
            sk, _ = chunk.run_chunk(chunk.init(), 0, steps, False)
            return (same and not _mismatches(torch, sc["params"], sa["params"])
                    and not _mismatches(torch, sa, sk))

        out["inf_equals_calm_async"] = inf_equals_calm(asyn)
        out["inf_equals_calm_sync"] = inf_equals_calm(sync)

        # armed: run_chunk == per-step, the whole state
        def chunk_vs_steps(kw):
            per = make_engine(task, RunConfig(**kw))
            st = per.init()
            for r in range(steps):
                st, _ = per.step(st, r)
            ch = make_engine(task, RunConfig(**kw))
            sc, _ = ch.run_chunk(ch.init(), 0, steps, False)
            return st, not _mismatches(torch, st, sc)

        for name, kw in (("armed_async", dict(asyn, **armed)),
                         ("armed_sync", dict(sync, **armed)),
                         ("collusion_learned_async", dict(asyn, **DEF_COLLUSION)),
                         ("collusion_learned_sync", dict(sync, **DEF_COLLUSION))):
            st, out[f"{name}_chunk_equals_per_step"] = chunk_vs_steps(kw)
            out[f"{name}_quarantined"] = float(st["defense"]["quarantined"])

        # crash-restart of an armed mtd + collusion run: 3 + 3 == 6
        crash_kw = dict(asyn, rounds=6, defense=True,
                        defense_kwargs={**DEF_ARMED, "collusion": True,
                                        "clique_min_obs": 2}, **DEF_ATTACK)
        full_eng = make_engine(task, RunConfig(**crash_kw))
        full, _ = full_eng.run_chunk(full_eng.init(), 0, 6, False)
        crashed = make_engine(task, RunConfig(**crash_kw))
        half, _ = crashed.run_chunk(crashed.init(), 0, 3, False)
        with tempfile.TemporaryDirectory() as d:
            tree = {"state": half, "draws": crashed.draws.get_state()}
            save_checkpoint(d, tree, step=3)
            restored, step = load_checkpoint(d, tree)
        restarted = make_engine(task, RunConfig(**crash_kw))
        restarted.draws.set_state(restored["draws"])
        resumed, _ = restarted.run_chunk(restored["state"], step, 3, False)
        out["crash_restart_bitwise"] = not _mismatches(torch, full, resumed)
        out["crash_restart_defense_stream"] = "defense" in tree["draws"]
        out["crash_restart_reads"] = [restarted.defense.restore_reads,
                                      restarted.defense.host_reads]

        # one replayed armed run: the card's discrete outputs equal the CPU's
        shapes = {p[:-2]: tuple(t.shape) for p, t in tree_paths(full["params"])
                  if p.endswith("/w")}
        init, per_step_draws = _replay(n, k, 10, steps, 2, task.examples_per_client,
                                       shapes, seed=3)
        rng = np.random.default_rng(4)
        init["faults/scale_attack/prone"] = rng.random(n, dtype=np.float32)
        for st_ in per_step_draws:
            st_["faults/scale_attack/hit"] = rng.random(k, dtype=np.float32)
            st_["defense/probation"] = rng.random(n, dtype=np.float32)
            st_["defense/readmit"] = rng.random(n, dtype=np.float32)
        replay_kw = dict(crash_kw, rounds=steps)
        tasks = {"cuda": task,
                 "cpu": make_cnn_task(MNIST_CNN, train, test, n, seed=0, device="cpu")}
        traces = {}
        for dev, tk in tasks.items():
            engine = make_engine(tk, RunConfig(**replay_kw),
                                 draws=ReplayDraws(init, per_step_draws, dev))
            pops, orig = [], ev_mod.pop_events

            def recording(ev, kk, *, use_kernel=None):
                res = orig(ev, kk, use_kernel=use_kernel)
                pops.append((res[1].cpu(), res[2].cpu()))
                return res

            ev_mod.pop_events = recording
            try:
                state, trace = engine.init(), []
                for r in range(steps):
                    state, aux = engine.step(state, r)
                    dst = state["defense"]
                    trace.append({
                        "send": aux["send"].cpu(), "ages": state["sched"]["ages"].cpu(),
                        "version": int(state["version"]),
                        "defense": {key: dst[key].cpu() for key in
                                    ("status", "level", "win", "quarantined",
                                     "readmitted", "pressure", "win_obs", "sk_obs",
                                     "clique_hits")},
                        "rep": dst["rep"].cpu(),
                        "counters": {key: float(v) for key, v in state["stats"].items()
                                     if key in ("updates", "aggs", "stale_max")},
                    })
            finally:
                ev_mod.pop_events = orig
            traces[dev] = (trace, pops)
        worst_rep = 0.0
        for r in range(steps):
            (a, (ai, av)), (b, (bi, bv)) = [(t[0][r], t[1][r]) for t in
                                            (traces["cuda"], traces["cpu"])]
            same = (torch.equal(a["send"], b["send"]) and torch.equal(ai, bi)
                    and torch.equal(av, bv) and torch.equal(a["ages"], b["ages"])
                    and a["version"] == b["version"] and a["counters"] == b["counters"]
                    and all(torch.equal(v, b["defense"][key])
                            for key, v in a["defense"].items()))
            if not same:
                raise AssertionError(f"defense_contracts: replay step {r} discrete "
                                     "outputs differ between the card and the CPU")
            worst_rep = max(worst_rep, float((a["rep"] - b["rep"]).abs().max()))
        last = traces["cpu"][0][-1]["defense"]
        out["replay_card_equals_cpu"] = True
        out["replay_max_rep_diff"] = worst_rep
        out["replay_defense"] = {key: v.tolist() for key, v in last.items()
                                 if v.dim() == 0}
        if not float(last["quarantined"]) > 0:
            raise AssertionError(f"defense_contracts: the replayed run quarantined "
                                 f"no one: {out['replay_defense']}")

        # the host-read rule, under CUDA's sync debug mode: the mtd run reads
        # the level once per closed window (windows close after steps 4 and
        # 6 here), the collusion + learned runs never read
        holder = {}
        mtd_eng = make_engine(task, RunConfig(**dict(asyn, rounds=8, **armed)))
        holder["st"], _ = mtd_eng.run_chunk(mtd_eng.init(), 0, 2, False)
        reads0 = mtd_eng.defense.host_reads

        def mtd_steps():
            holder["st"], _ = mtd_eng.run_chunk(holder["st"], 2, 4, False)

        out["mtd_syncs_in_4_steps"] = len(_syncs_in(torch, mtd_steps))
        out["mtd_level_reads_in_4_steps"] = mtd_eng.defense.host_reads - reads0
        for name, kw in (("async", asyn), ("sync", sync)):
            eng = make_engine(task, RunConfig(**dict(kw, **DEF_COLLUSION)))
            holder["st"], _ = eng.run_chunk(eng.init(), 0, 1, False)

            def two_steps():
                holder["st"], _ = eng.run_chunk(holder["st"], 1, 2, False)

            out[f"collusion_learned_{name}_syncs_in_2_steps"] = len(_syncs_in(torch, two_steps))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    out["k1_launches"] = fedavg_reduce.launches - k1_before
    out["seconds"] = time.time() - t_start
    failed = [key for key in ("off_adds_no_state", "inf_equals_calm_async",
                              "inf_equals_calm_sync", "armed_async_chunk_equals_per_step",
                              "armed_sync_chunk_equals_per_step",
                              "collusion_learned_async_chunk_equals_per_step",
                              "collusion_learned_sync_chunk_equals_per_step",
                              "crash_restart_bitwise", "crash_restart_defense_stream")
              if not out[key]]
    if failed:
        raise AssertionError(f"defense_contracts: {failed} do not hold")
    expect = {"crash_restart_reads": [1, 2], "mtd_syncs_in_4_steps": 2,
              "mtd_level_reads_in_4_steps": 2,
              "collusion_learned_async_syncs_in_2_steps": 0,
              "collusion_learned_sync_syncs_in_2_steps": 0}
    wrong = {key: out[key] for key, v in expect.items() if out[key] != v}
    if wrong:
        raise AssertionError(f"defense_contracts: host reads {wrong}, expected "
                             f"{ {key: expect[key] for key in wrong} }")
    if not out["k1_launches"] > 0:
        raise AssertionError("defense_contracts: K1 (the robust center) never launched")
    if not (out["armed_async_quarantined"] > 0 and out["armed_sync_quarantined"] > 0):
        raise AssertionError(f"defense_contracts: the armed runs quarantined no one: {out}")
    emit({**out, "ok": True})
    return out["k1_launches"]


def phase_async_defense(torch, event_topk, fedavg_reduce, calm):
    """``main``'s configuration cut to ASYNC_DEFENSE_STEPS steps under the
    pinned attack (scale_attack x -3 on a quarter of the fleet, every pop)
    with ``--defense --collusion`` (threshold 0.55, ewma 0.5) and
    ``fault_exposure``: the step time beside ``main``'s, with TF32 as
    ``main`` ran it. Returns the K2 and K1 launches."""
    with _TF32(torch, calm["tf32"]):
        return _async_defense(torch, event_topk, fedavg_reduce, calm)


def _async_defense(torch, event_topk, fedavg_reduce, calm):
    import dataclasses

    from repro_torch.engine import make_engine
    from repro_torch.launch import fl_async

    t_start = time.time()
    argv = MAIN_ARGV[:-1] + [str(ASYNC_DEFENSE_STEPS)] + ASYNC_DEFENSE_FLAGS
    args = fl_async.parse_args(argv)
    task, engine = fl_async.build(args)
    # the attack's factor and coalition and the EWMA have no flag
    cfg = dataclasses.replace(engine.cfg, fault_kwargs=DEF_ATTACK["fault_kwargs"],
                              fault_exposure=True,
                              defense_kwargs={**engine.cfg.defense_kwargs, "ewma": 0.5})
    engine = make_engine(task, cfg)
    setup_s = time.time() - t_start
    first, run_chunk = {}, engine.run_chunk

    def recording(state, *rest):  # the reputations after the first step
        out = run_chunk(state, *rest)
        if not first:
            first["rep"] = out[0]["defense"]["rep"].clone()
            first["exposed"] = out[0]["faults"]["scale_attack"]["exposed"].clone()
        return out

    engine.run_chunk = recording
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    event_topk.launches = fedavg_reduce.launches = 0
    try:
        res, state = _run_captured(engine, progress=True)
    finally:
        engine.run_chunk = run_chunk
    k2, k1 = event_topk.launches, fedavg_reduce.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    fl_async.report(res, args)
    ls = res.load_stats
    if (k2, k1) != (cfg.rounds, cfg.rounds):
        raise AssertionError(f"async_defense: K2 {k2} and K1 {k1} launches in "
                             f"{cfg.rounds} steps, expected one each a step (K1: the "
                             "robust center)")
    off = [p for p, t in _state_tensors(state)
           if not (isinstance(t, torch.Tensor) and t.is_cuda)]
    if off:
        raise AssertionError(f"async_defense: engine state off the GPU: {off}")
    # a cost phase: in 10 steps a client is popped about 0.16 times, and at
    # ewma 0.5 one observation leaves even a -3x attacker below the 0.55
    # threshold, so few or none are quarantined and fedbuff (no robust
    # rule) may diverge under the attack; the scores must still separate
    evals = [r.eval_loss for r in res.records]
    rep1, hit1 = first["rep"].cpu(), first["exposed"].cpu() > 0
    honest1 = ~hit1 & (rep1 > 0)
    sep = {"exposed_after_step_1": int(hit1.sum()),
           "rep_exposed_mean_after_step_1": float(rep1[hit1].mean()) if hit1.any() else None,
           "rep_honest_scored_mean_after_step_1":
               float(rep1[honest1].mean()) if honest1.any() else 0.0}
    if not (ls["fault_scale_attack_injected"] > 0 and hit1.any()
            and sep["rep_exposed_mean_after_step_1"]
            > sep["rep_honest_scored_mean_after_step_1"]):
        raise AssertionError(f"async_defense: the attack did not hit, or the first "
                             f"step's reputations do not separate the attackers: {sep}")
    state, syncs = sync_free_steps(torch, engine, state, cfg.rounds)
    if syncs:
        raise AssertionError(f"async_defense: a step synchronized with the host: {syncs}")
    out = {"phase": "async_defense", "ok": True, "argv": argv, "tf32": calm["tf32"],
           "fault_kwargs": cfg.fault_kwargs, "defense_kwargs": cfg.defense_kwargs,
           "k2_launches": k2, "k1_launches": k1, "steps": cfg.rounds,
           "steps_per_s": cfg.rounds / res.wall_time_s, "setup_s": setup_s,
           "eval_loss": evals[-1], "accuracy": res.records[-1].accuracy,
           "injected": ls["fault_scale_attack_injected"], **_def_counters(ls),
           "detection": _detection(res, "scale_attack"), **sep,
           "eval_losses": evals,
           "updates_applied": res.wall_stats["updates_applied"],
           "peak_mem_gib": peak_gib, "host_syncs_in_2_steps": 0}
    out.update(steady_and_profile(torch, engine, state, cfg.rounds + 2,
                                  res.wall_time_s, match="fedavg_reduce"))
    out["main_steady_ms_per_step"] = calm["steady_ms_per_step"]
    out["defense_over_main"] = out["steady_ms_per_step"] / calm["steady_ms_per_step"]
    out["seconds"] = time.time() - t_start
    emit(out)
    return k2, k1


def phase_sync_defense(torch, fedavg_reduce, tf32, fedavg_attack):
    """``sync_main`` cut to SYNC_DEFENSE_ROUNDS rounds under
    ``benchmarks/bench_defense.py``'s pinned attack and knobs, with TF32 as
    ``sync_main`` ran it: (a) the trim ladder over fedavg under the scale
    attack, (b) the family ladder, (c) the collude coalition under
    collusion scoring and the learned head. ``fedavg_attack`` is
    ``sync_attack``'s fedavg row, printed beside. Returns K1's launches."""
    with _TF32(torch, tf32):
        return _sync_defense(torch, fedavg_reduce, tf32, fedavg_attack)


def _sync_defense(torch, fedavg_reduce, tf32, fedavg_attack):
    import dataclasses

    from repro_torch.engine import make_engine
    from repro_torch.launch import fl_train
    from repro_torch.launch._fl_cli import build_run_config, build_task

    t_start = time.time()
    argv = SYNC_ARGV[:-1] + [str(SYNC_DEFENSE_ROUNDS)]
    args = fl_train.parse_args(argv)
    task = build_task(args)
    base = build_run_config(args, mode="sync", eval_div=30)
    attack = dict(DEF_ATTACK, fault_exposure=True)
    runs = {
        "a_trim_ladder": (SYNC_DEFENSE_ROUNDS, "scale_attack", dict(
            defense=True, defense_kwargs={**BENCH_DEFENSE, **BENCH_MTD}, **attack)),
        "b_family_ladder": (10, "scale_attack", dict(
            defense=True, defense_kwargs={**BENCH_DEFENSE, **BENCH_MTD,
                                          "mtd_families": FAMILIES}, **attack)),
        "c_collusion_learned": (SYNC_DEFENSE_ROUNDS, "collude", dict(
            defense=True, defense_kwargs={**BENCH_COLLUSION, "detector": "learned"},
            fault_exposure=True, **COLLUDE_ATTACK)),
    }
    rows, total_k1 = {}, 0
    for name, (rounds, fault, kw) in runs.items():
        cfg = dataclasses.replace(base, rounds=rounds, eval_every=max(rounds // 30, 1),
                                  **kw)
        engine = make_engine(task, cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fedavg_reduce.launches = 0
        res, state = _run_captured(engine)
        launches = fedavg_reduce.launches
        total_k1 += launches
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        steady, _ = _steady_ms(torch, engine, state, rounds, 3, cfg.eval_every)
        last, ls = res.records[-1], res.load_stats
        rows[name] = {
            "rounds": rounds, "defense_kwargs": cfg.defense_kwargs,
            "fault": fault, "fault_kwargs": cfg.fault_kwargs,
            "eval_loss": last.eval_loss, "accuracy": last.accuracy,
            "first_eval_loss": res.records[0].eval_loss,
            "injected": ls[f"fault_{fault}_injected"], **_def_counters(ls),
            "detection": _detection(res, fault), "k1_launches": launches,
            "rounds_per_s": rounds / res.wall_time_s, "steady_ms_per_round": steady,
            "peak_mem_gib": peak_gib,
        }
        print(f"  sync_defense {name}: eval_loss={last.eval_loss:.4f} "
              f"acc={last.accuracy:.4f} {rows[name]['detection']} "
              f"{_def_counters(ls)}", flush=True)
        bad_k1 = launches != 2 * rounds if name != "b_family_ladder" else launches < 2 * rounds
        if bad_k1:
            raise AssertionError(f"sync_defense {name}: K1 launched {launches} times in "
                                 f"{rounds} rounds, expected two a round (fedavg and "
                                 "the robust center)")
        if not all(math.isfinite(r.eval_loss) for r in res.records):
            raise AssertionError(f"sync_defense {name}: eval losses "
                                 f"{[r.eval_loss for r in res.records]}")
    a = rows["a_trim_ladder"]
    if not (a["def_quarantine_inflow"] > 0 and a["detection"]["flagged_exposed"] >= 1):
        raise AssertionError(f"sync_defense: run (a) caught no attacker: {a}")
    emit({"phase": "sync_defense", "ok": True, "argv": argv, "tf32": tf32, "runs": rows,
          "sync_attack_fedavg": {key: fedavg_attack[key] for key in
                                 ("eval_loss", "accuracy", "steady_ms_per_round")},
          "seconds": time.time() - t_start})
    return total_k1


# --- slice F: fleet sharding ----------------------------------------------------

SHARD_POLICIES = ("markov", "oldest_age", "round_robin")
SHARD_TASK = {"n": FAULT_N, "scale": 0.02, "device": "cuda:0"}  # full-width CNN
SHARD_CFG = dict(n_clients=FAULT_N, k=FAULT_K, m=10, policy="markov",
                 rounds=FAULT_STEPS, local_epochs=2, batch_size=50, lr0=0.02,
                 seed=0, mode="async", profile="lognormal")
SHARD_HIER = dict(topology="hierarchical",
                  topology_kwargs={"tiers": (4, 2), "heartbeat_timeout": TOPO_HB})
SHARD_DEFENSE = dict(DEF_COLLUSION, **COLLUDE_ATTACK)
COHORT_TOL = (5e-4, 1e-5)  # the CPU tests' shard_cohort tolerance (rtol, atol)
SHARDED_ARGV = MAIN_ARGV + ["--mesh-shards", "1"]


def _host_bits_equal(a, b) -> bool:
    """Two host result trees (``launch.ranks.run_case``'s) equal bit for
    bit."""
    import numpy as np

    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_host_bits_equal(a[k], b[k]) for k in a)
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _host_close(a, b, tol) -> bool:
    import numpy as np

    if isinstance(a, dict):
        return all(_host_close(a[k], b[k], tol) for k in a)
    return bool(np.allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                            rtol=tol[0], atol=tol[1], equal_nan=True))


def phase_shard_contracts(torch, fedavg_reduce):
    """Slice F's contracts on ``fault_contracts``' fleet (48 clients, the
    paper CNN at full widths, k = B = 8), cuDNN deterministic inside
    (restored after): a world of one on NCCL in this process, the sharded
    engine bitwise the one-device engine per step and chunked, three
    policies x two aggregators, under hierarchical (4, 2) with a heartbeat
    and under the armed defense with collusion; then a world of two through
    gloo, both ranks spawned on cuda:0 (``launch/ranks.py``), TF32 off in
    the ranks: sharded == one device bitwise, cohort-parallel async and
    sync allclose to the replicated runs at the CPU tests' tolerance.
    Checks and times nothing else."""
    import tempfile

    from repro_torch.launch import ranks

    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    t0 = time.time()
    try:
        def case(name, drive="per_step", **kw):
            return {"name": name, "task": SHARD_TASK, "drive": drive,
                    "deterministic": True,
                    "cfg": {**SHARD_CFG, "mesh_shards": 0, **kw}}

        one = [case(f"{p}-{a}-{d}", d, policy=p, aggregator=a)
               for p in SHARD_POLICIES for a in ("fedbuff", "fedavg")
               for d in ("per_step", "chunked")]
        one += [case("hier", **SHARD_HIER), case("defense", "chunked", **SHARD_DEFENSE)]
        checks = {}
        for c in one:
            got = ranks.run_case(c, ranks.case_engine(c))
            want = ranks.run_case(c, ranks.case_engine(ranks.single_case(c)))
            checks[c["name"]] = {"backend": str(torch.distributed.get_backend()),
                                 "world": torch.distributed.get_world_size(),
                                 "equal": all(_host_bits_equal(got[k], want[k])
                                              for k in ("send", "loss", "state"))}
        # the ranks start with torch's TF32 defaults: the allclose checks
        # run with TF32 off, as the parity phases do
        two = [dict(c, tf32=False) for c in (
            case("markov-fedbuff-2"),
            case("cohort-async", "run_engine", shard_cohort=True),
            case("cohort-sync", "run_engine", shard_cohort=True, mode="sync",
                 aggregator="fedavg", profile="lognormal"))]
        with tempfile.TemporaryDirectory() as tmp:
            res = ranks.run_cases_on_ranks(
                two + [ranks.single_case(c) for c in two], 2, tmp, backend="gloo",
                devices=["cuda:0", "cuda:0"], timeout=300)
        a, b = res[:3], res[3:]
        checks["markov-fedbuff-2"] = {
            "backend": "gloo", "world": 2,
            "equal": all(_host_bits_equal(a[0][k], b[0][k])
                         for k in ("send", "loss", "state"))}
        for i, name in ((1, "cohort-async"), (2, "cohort-sync")):
            checks[name] = {
                "backend": "gloo", "world": 2, "tolerance": COHORT_TOL,
                "selection_equal": _host_bits_equal(a[i]["selection"], b[i]["selection"]),
                "params_close": _host_close(a[i]["params"], b[i]["params"], COHORT_TOL)}
        bad = [n for n, c in checks.items()
               if not all(v for k, v in c.items() if k in ("equal", "selection_equal",
                                                          "params_close"))]
        if bad:
            raise AssertionError(f"shard_contracts: failed {bad}: {checks}")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    emit({"phase": "shard_contracts", "ok": True, "n": FAULT_N, "k": FAULT_K,
          "steps": FAULT_STEPS, "cnn": "paper-cnn-mnist (full widths)",
          "cudnn_deterministic": True, "checks": checks,
          "seconds": time.time() - t0})


def phase_sharded_main(torch, event_topk, k3, calm):
    """``main``'s configuration under ``--mesh-shards 1`` on NCCL, with TF32
    as ``main`` ran it: the final params and selection history bitwise
    ``main``'s, K2 once a step (each rank's local pop), the steady ms a step
    beside ``main``'s, the state bytes this rank holds and peak memory;
    then ``oldest_age_step_sharded`` at ``_policy_1m``'s shape on the world
    of one: one K3 launch, its mask the port's ``oldest_age`` policy mask
    on the same scores."""
    with _TF32(torch, calm["tf32"]):
        return _sharded_main(torch, event_topk, k3, calm)


def _sharded_main(torch, event_topk, k3, calm):
    from repro_torch.core import distributed as dist
    from repro_torch.core import selection
    from repro_torch.core.draws import GeneratorDraws
    from repro_torch.engine.sharded import ShardedAsyncEngine
    from repro_torch.launch import fl_async

    args = fl_async.parse_args(SHARDED_ARGV)
    t0 = time.time()
    task, engine = fl_async.build(args)
    setup_s = time.time() - t0
    if not isinstance(engine, ShardedAsyncEngine):
        raise AssertionError(f"sharded_main: built {type(engine).__name__}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gib = torch.cuda.memory_allocated() / 2**30  # earlier phases' and the task's
    event_topk.launches = 0
    res, state = _run_captured(engine, progress=True)
    k2 = event_topk.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    cfg = res.config
    if k2 != cfg.rounds:
        raise AssertionError(f"sharded_main: K2 launched {k2} times in {cfg.rounds} steps")
    same_sel = bool((res.selection == calm["selection"]).all())
    bad = _mismatches(torch, res.params, calm["params"])
    if not same_sel or bad:
        raise AssertionError(f"sharded_main: differs from main: selection equal "
                             f"{same_sel}, params differing {bad}")
    out = {"phase": "sharded_main", "ok": True, "argv": SHARDED_ARGV,
           "backend": engine.mesh.backend, "world": engine.mesh_shards,
           "tf32": calm["tf32"], "k2_launches": k2, "steps": cfg.rounds,
           "selection_equal_main": same_sel, "params_equal_main": True,
           "steps_per_s": cfg.rounds / res.wall_time_s, "setup_s": setup_s,
           "eval_loss": res.records[-1].eval_loss,
           "per_device_state_bytes": engine.per_device_state_bytes(state),
           "fleet_state_bytes": engine.fleet_state_bytes(state),
           "main_state_bytes": calm["state_bytes"], "peak_mem_gib": peak_gib,
           "base_mem_gib": base_gib, "main_peak_mem_gib": calm["peak_mem_gib"],
           "main_base_mem_gib": calm["base_mem_gib"],
           # what each run added over what was allocated when it started
           "run_mem_gib": peak_gib - base_gib,
           "main_run_mem_gib": calm["peak_mem_gib"] - calm["base_mem_gib"]}
    state, syncs = sync_free_steps(torch, engine, state, cfg.rounds)
    out["host_syncs_in_2_steps"] = len(syncs)  # reported: no contract yet
    out["host_syncs_first"] = syncs[:3]
    # the collectives of one step: every one is an all_gather
    gather, calls = dist.all_gather, []

    def counting(x, mesh):
        calls.append(x.numel() * x.element_size())
        return gather(x, mesh)

    dist.all_gather = counting
    try:
        state, _ = engine.run_chunk(state, cfg.rounds + 2, 1, False)
    finally:
        dist.all_gather = gather
    out["collectives_per_step"] = len(calls)
    out["gathered_bytes_per_step_per_rank"] = sum(calls)
    out.update(steady_and_profile(torch, engine, state, cfg.rounds + 3, res.wall_time_s,
                                  match="nccl"))
    out["main_steady_ms_per_step"] = calm["steady_ms_per_step"]
    out["sharded_over_main"] = out["steady_ms_per_step"] / calm["steady_ms_per_step"]
    del state, engine, task
    torch.cuda.empty_cache()

    # the centralized comparator at 1M clients on the world of one
    n, k = 1_000_000, 150_000
    policy = selection.make_policy("oldest_age", n, k)
    pstate = policy.init(GeneratorDraws(5, "cuda"), n)
    mask, _ = policy.step(pstate, GeneratorDraws(6, "cuda"))
    score = pstate["ages"].to(torch.float32) + GeneratorDraws(6, "cuda").uniform(
        "select", (n,), 0.0, 0.5)
    step = dist.oldest_age_step_sharded(dist.fleet_mesh(1, device="cuda"), k)
    torch.cuda.synchronize()
    k3.launches = 0
    sel, _, chosen = step(score)
    torch.cuda.synchronize()
    k3_launches = k3.launches
    if k3_launches != 1 or not torch.equal(sel, mask) or int(sel.sum()) != k:
        raise AssertionError(f"sharded_main: oldest_age_step_sharded launched K3 "
                             f"{k3_launches} times, mask equal {torch.equal(sel, mask)}")
    t1 = time.perf_counter()
    for _ in range(5):
        step(score)
    torch.cuda.synchronize()
    out["oldest_age_1m"] = {"n": n, "k": k, "k3_launches": k3_launches,
                            "mask_equal_policy": True, "chosen": int(chosen.numel()),
                            "ms": (time.perf_counter() - t1) * 1e3 / 5,
                            "comm_bytes": dist.scheduler_comm_bytes(n, k, 1)}
    emit(out)
    return k2, k3_launches


def _attn_inputs(torch, gen, shape, dtype, decode=False):
    """q, k, v on the card from ``gen``; for decode, k/v are views of a
    (B, L, Hk, D) cache, the model's layout."""
    if decode:
        B, Hk, G, L, D = shape
        q = torch.randn((B, Hk, G, D), generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn((B, L, Hk, D), generator=gen, device="cuda").to(dtype)
                .permute(0, 2, 1, 3) for _ in range(2))
        return q, k, v
    B, Hk, G, S, D = shape
    q = torch.randn((B, Hk, G, S, D), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((B, Hk, S, D), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    return q, k, v


def _check_against_plain(torch, name, fn, plain, dtype):
    """Kernel vs plain on the same inputs at the reference's tolerance; two
    launches bitwise equal. Returns the max abs error."""
    out, again, ref = fn(), fn(), plain()
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError(f"{name}: launches differ bitwise")
    tol = ATTN_TOL[str(dtype).replace("torch.", "")]
    if not torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol):
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(max abs err {float((out.float() - ref.float()).abs().max())})")
    return float((out.float() - ref.float()).abs().max())


def _model_layout(torch, gen, shape, dtype):
    """q, k, v on the card as the model passes them to K4: q a view of
    (B, S, H, D), k and v views of (B, S, Hk, D)."""
    B, Hk, G, S, D = shape
    q = torch.randn((B, S, Hk * G, D), generator=gen, device="cuda").to(dtype)
    q = q.view(B, S, Hk, G, D).permute(0, 2, 3, 1, 4)
    k, v = (torch.randn((B, S, Hk, D), generator=gen, device="cuda").to(dtype)
            .permute(0, 2, 1, 3) for _ in range(2))
    return q, k, v


def phase_kernel_k4(torch, k4):
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(4)
    bf16, f32 = torch.bfloat16, torch.float32
    B, S = PREFILL_SHAPE
    main = (B, 4, 8, S, 64)  # tinyllama-1.1b: 4 kv heads, 8 query heads each, D 64
    cases = [(main, "full", 0, bf16, "contiguous"), (main, "full", 0, bf16, "model")] + [
        (shape, kind, w, dt, "contiguous") for dt in (f32, bf16) for shape, kind, w in [
            ((1, 2, 2, 256, 64), "full", 0), ((2, 1, 4, 512, 32), "full", 0),
            ((1, 2, 1, 512, 128), "sliding", 128), ((1, 1, 2, 512, 64), "chunked", 128),
            ((1, 4, 8, 256, 64), "full", 0), ((1, 2, 2, 384, 64), "full", 0)]]
    # the bf16 kernel's shapes in the model's layout: every G up to 16, each
    # head dim, ragged S, and windows that are not multiples of the key tile
    cases += [((1, 2, G, 384, D), "full", 0, bf16, "model")
              for D in (32, 64, 128) for G in (1, 2, 4, 5, 8, 16)]
    cases += [((1, 2, 4, 200, 64), "full", 0, bf16, "model")]
    cases += [((1, 2, G, Sx, D), kind, w, bf16, "model")
              for kind in ("sliding", "chunked") for w in (100, 128)
              for G, Sx, D in ((4, 384, 64), (5, 200, 32), (8, 2048, 128))]
    # gemma3's local layers; f32 holds the window of 1024 tightly, since at
    # bf16's tolerance a window off by a few keys would pass
    cases += [(G3_K4_SHAPE, "sliding", G3_WINDOW, bf16, "model"),
              (G3_K4_SHAPE, "sliding", G3_WINDOW, f32, "contiguous")]
    errs = {}
    for shape, kind, w, dt, layout in cases:
        q, k, v = (_model_layout(torch, gen, shape, dt) if layout == "model"
                   else _attn_inputs(torch, gen, shape, dt))
        scale = shape[-1] ** -0.5
        name = f"{tuple(shape)}_{kind}{w or ''}_{str(dt)[6:]}_{layout}"
        Sx = shape[3]  # block sizes must divide S; 384 keeps the uneven-blocks case
        block_q = 128 if Sx % 128 == 0 else Sx
        block_k = 384 if Sx == 384 else block_q
        errs[name] = _check_against_plain(
            torch, f"K4 {name}",
            lambda: k4.flash_attention(q, k, v, scale=scale, kind=kind, window=w,
                                       block_q=block_q, block_k=block_k),
            lambda: k4.flash_attention_plain(q, k, v, scale=scale, kind=kind,
                                             window=w), dt)
    # the serving prefill shape in the model's layout, as serve_main passes it
    q, k, v = _model_layout(torch, gen, main, bf16)
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    _, Hk, G, _, D = main
    qh = q.reshape(B, Hk * G, S, D)  # the same work as one MHA call
    kh, vh = (t.repeat_interleave(G, dim=1) for t in (k, v))
    run = lambda: k4.flash_attention(q, k, v, scale=0.125)  # noqa: E731
    run_contig = lambda: k4.flash_attention(qc, kc, vc, scale=0.125)  # noqa: E731
    sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)  # noqa: E731
    ops, *rw = k4.cost(B, Hk, G, S, D, bf16)  # 4 D a causal pair; q, k, v in; o out
    nbytes = sum(rw)
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3
    entry = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:92",
        "max_abs_err": errs[f"{main}_full_bfloat16_model"],
        "ms": cuda_ms(torch, run, calls=20),
        "plain_ms": cuda_ms(torch, lambda: k4.flash_attention_plain(q, k, v, scale=0.125),
                            calls=3, trials=3),
        "bound_ms": bound_ms,
        "bound_by": "operations" if ops / BF16_OPS_PER_S > nbytes / HBM_BYTES_PER_S
        else "bytes",
        "library_ms": cuda_ms(torch, sdpa, calls=20),
    }
    dev_ms = device_ms(torch, run)
    emit({"phase": "kernel_k4", "ok": True, "cases": len(cases), "shape": list(main),
          "dtype": "bfloat16", "layout": "model", **entry, "device_ms": dev_ms,
          "library_device_ms": device_ms(torch, sdpa),
          "contiguous_ms": cuda_ms(torch, run_contig, calls=20),
          "contiguous_device_ms": device_ms(torch, run_contig),
          "tflops": ops / (entry["ms"] * 1e-3) / 1e12,
          "device_tflops": ops / (dev_ms * 1e-3) / 1e12,
          "share_of_bound": bound_ms / dev_ms,
          "library_tflops": ops / (entry["library_ms"] * 1e-3) / 1e12,
          "max_abs_err_by_case": errs})
    return entry


def phase_kernel_k5(torch, k5):
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(5)
    bf16, f32 = torch.bfloat16, torch.float32
    B, P, G_ = SERVE_ARGS["batch"], SERVE_ARGS["prompt_len"], SERVE_ARGS["gen"]
    main = (B, 4, 8, P + G_, 64)  # the serving decode: cache of prompt + gen slots
    nsplit, split = k5.plan_splits(P + G_)
    cases = [(main, P + G_, bf16), (main, P + 1, bf16)] + [
        (shape, vlen, dt) for dt in (f32, bf16) for shape, vlen in [
            ((2, 2, 4, 512, 64), 512), ((1, 4, 1, 1024, 128), 700),
            ((1, 1, 8, 384, 64), 384), ((3, 2, 2, 256, 64), (64, 128, 256)),
            ((2, 2, 3, 100, 32), 0)]]
    # cases that cut a split: L not a multiple of 8; valid_len of 1, inside
    # the first split, at a split edge, and 0; rows that end in different
    # splits (one of them empty)
    cases += [((2, 2, 4, 100, 64), 100, bf16), ((2, 2, 4, 643, 64), 643, f32),
              ((2, 2, 4, 643, 64), (81, 600), bf16), (main, 1, bf16),
              (main, split // 2, bf16), (main, split, bf16), (main, 0, bf16),
              (main, (1, split, split + 1, 2 * split, P + G_ - 1, P + G_, 0, P - 1), bf16)]
    # serve_loop's slot pool: 8 rows of one replica, each at its own position
    pool_ctx = SERVE_TRACE["prompt_len"] + 2 * SERVE_TRACE["gen_len"]
    pool_shape, pool_vlen = (8, 4, 8, pool_ctx, 64), (1, pool_ctx, 33, 40, 64, 2, pool_ctx - 1, 50)
    cases.append((pool_shape, pool_vlen, bf16))
    # gemma3-27b's decode on its window rings (L = W = 1024): sliding rows
    # past the wrap and not, chunked rows at index % W + 1; f32 holds each
    # valid_len tightly (one slot more or fewer moves a row by about 1e-3)
    cases += [(G3_K5_SHAPE, vlen, dt) for dt in (bf16, f32)
              for vlen in ((1024, 301), (905, 1))]
    errs = {}
    for shape, vlen, dt in cases:
        q, k, v = _attn_inputs(torch, gen, shape, dt, decode=True)
        vl = torch.tensor(vlen, dtype=torch.int32, device="cuda")
        scale = shape[-1] ** -0.5
        name = f"{tuple(shape)}_v{vlen}_{str(dt)[6:]}"
        errs[name] = _check_against_plain(
            torch, f"K5 {name}", lambda: k5.flash_decode(q, k, v, vl, scale=scale),
            lambda: k5.flash_decode_plain(q, k, v, vl, scale=scale), dt)
    q, k, v = _attn_inputs(torch, gen, main, bf16, decode=True)
    Bm, Hk, G, L, D = main
    vl = torch.tensor(L, dtype=torch.int32, device="cuda")
    run = lambda: k5.flash_decode(q, k, v, vl, scale=0.125)  # noqa: E731
    qh = q.reshape(Bm, Hk * G, 1, D)
    kh, vh = (t.repeat_interleave(G, dim=1) for t in (k, v))
    mask = (torch.arange(L, device="cuda") < vl)[None, None, None].expand(Bm, 1, 1, L)
    lib = lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)  # noqa: E731
    ops, *rw = k5.cost(Bm, Hk, G, L, D, bf16)  # the valid K, V; q in, o out
    nbytes = sum(rw)
    entry = {
        "name": "flash_decode", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode.py:82",
        "max_abs_err": errs[f"{main}_v{L}_bfloat16"],
        "ms": cuda_ms(torch, run),
        "plain_ms": cuda_ms(torch, lambda: k5.flash_decode_plain(q, k, v, vl, scale=0.125)),
        "bound_ms": max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3,
        "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= ops / BF16_OPS_PER_S
        else "operations",
        "library_ms": cuda_ms(torch, lib),
    }
    qp, kp, vp = _attn_inputs(torch, gen, pool_shape, bf16, decode=True)
    vlp = torch.tensor(pool_vlen, dtype=torch.int32, device="cuda")
    # the K/V rows the ragged call must read
    pool_bytes = sum(k5.cost(*pool_shape, bf16, valid_rows=sum(pool_vlen))[1:])
    per_row = {"shape": list(pool_shape), "valid_len": list(pool_vlen),
               "max_abs_err": errs[f"{pool_shape}_v{pool_vlen}_bfloat16"],
               "ms": cuda_ms(torch, lambda: k5.flash_decode(qp, kp, vp, vlp, scale=0.125)),
               "plain_ms": cuda_ms(torch, lambda: k5.flash_decode_plain(qp, kp, vp, vlp,
                                                                        scale=0.125)),
               "device_ms": device_ms(torch, lambda: k5.flash_decode(qp, kp, vp, vlp,
                                                                     scale=0.125)),
               "bound_ms": pool_bytes / HBM_BYTES_PER_S * 1e3}
    qg, kg, vg = _attn_inputs(torch, gen, G3_K5_SHAPE, bf16, decode=True)
    vlg = torch.tensor((1024, 301), dtype=torch.int32, device="cuda")
    g3_bytes = sum(k5.cost(*G3_K5_SHAPE, bf16, valid_rows=sum((1024, 301)))[1:])
    window = {"shape": list(G3_K5_SHAPE), "valid_len": [1024, 301],
              "max_abs_err": errs[f"{G3_K5_SHAPE}_v(1024, 301)_bfloat16"],
              "ms": cuda_ms(torch, lambda: k5.flash_decode(qg, kg, vg, vlg, scale=128**-0.5)),
              "device_ms": device_ms(torch, lambda: k5.flash_decode(qg, kg, vg, vlg,
                                                                    scale=128**-0.5)),
              "bound_ms": g3_bytes / HBM_BYTES_PER_S * 1e3}
    emit({"phase": "kernel_k5", "ok": True, "cases": len(cases), "shape": list(main),
          "dtype": "bfloat16", "cluster_size": nsplit, "split_slots": split,
          "ctas": nsplit * Bm * Hk * -(-G // 8), "sms": torch.cuda.get_device_properties(
              0).multi_processor_count, **entry, "device_ms": device_ms(torch, run),
          "library_device_ms": device_ms(torch, lib), "max_abs_err_by_case": errs,
          "per_row_valid_len": per_row, "gemma3_window": window})
    return entry


def _count_calls(module, names, counts):
    """Wrap ``module.<name>`` for each name so ``counts[name]`` counts its
    calls; returns a function that restores the originals."""
    saved = {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        def counted(*args, **kw):
            counts[name] = counts.get(name, 0) + 1
            return fn(*args, **kw)
        return counted

    for n, fn in saved.items():
        setattr(module, n, wrap(n, fn))
    return lambda: [setattr(module, n, fn) for n, fn in saved.items()]


def _syncs_in(torch, fn):
    """Messages of the synchronizing CUDA operations ``fn`` makes, under
    ``torch.cuda.set_sync_debug_mode``; a known sync (``.item()``) right
    after is the control: the mode must report it."""
    def is_sync(w):
        msg = str(w.message)
        return "synchroniz" in msg and "prototype feature" not in msg

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
            n_in = len(caught)
            torch.zeros((), device="cuda").item()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    if not any(map(is_sync, caught[n_in:])):
        raise AssertionError("sync debug mode missed a known sync (.item())")
    return [str(w.message) for w in caught[:n_in] if is_sync(w)]


def _profile(torch, fn, calls):
    """Device time of ``fn`` over ``calls`` calls (``torch.profiler``): the
    union of kernel intervals, the host-clock window, summed kernel time by
    name, and the number of kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + ev.self_device_time_total / 1e3
    kernels = [(ev.time_range.start, ev.time_range.end) for ev in prof.events()
               if ev.device_type == DeviceType.CUDA]
    return _union_ms(kernels), window_ms, by_name, len(kernels)


def _share(by_name, match):
    total = sum(by_name.values())
    return sum(ms for name, ms in by_name.items() if match in name) / total if total else 0.0


def phase_serve_main(torch, k4, k5):
    from repro_torch.configs import get_arch
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import factory
    from repro_torch.serve.batching import prefill_tokens

    cfg = get_arch(LM_ARCH)
    model = factory.build(cfg)
    n_layers = cfg.num_layers
    t0 = time.time()
    params = model.init(torch.Generator(device="cuda").manual_seed(SERVE_ARGS["seed"]))
    torch.cuda.synchronize()
    init_s = time.time() - t0
    param_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    B, S = PREFILL_SHAPE
    toks = torch.randint(0, cfg.vocab_size, (B, S), device="cuda", dtype=torch.int32,
                         generator=torch.Generator(device="cuda").manual_seed(1))
    plain_calls = {}
    restore = [_count_calls(k4, ["flash_attention_plain"], plain_calls),
               _count_calls(k5, ["flash_decode_plain"], plain_calls),
               _count_calls(attn_mod, ["_attend_direct", "_attend_flash_jnp"], plain_calls)]
    try:
        with torch.no_grad():
            prefill = lambda: model.prefill(params, {"tokens": toks})  # noqa: E731
            prefill()  # warm-up (cuBLAS handles, kernel library load)
            torch.cuda.synchronize()
            k4.launches = k5.launches = 0
            t0 = time.perf_counter()
            logits, caches = prefill()
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            k4_launches, k5_prefill = k4.launches, k5.launches
            if not bool(torch.isfinite(logits).all()) or logits.shape != (B, 1, cfg.vocab_size):
                raise AssertionError("serve_main: prefill logits not finite / of shape")
            if k4_launches != n_layers or k5_prefill:
                raise AssertionError(f"serve_main: model.prefill launched K4 {k4_launches} "
                                     f"and K5 {k5_prefill} times ({n_layers} layers)")
            del caches
            p_union, p_window, p_by, _ = _profile(torch, prefill, 2)
            torch.cuda.reset_peak_memory_stats()
            k4.launches = k5.launches = 0
            res = serve_mod.serve(cfg, device="cuda", params=params, **SERVE_ARGS)
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
            k5_launches, k4_serve = k5.launches, k4.launches
        steps = SERVE_ARGS["prompt_len"] + SERVE_ARGS["gen"]
        if k5_launches != n_layers * steps or k4_serve:
            raise AssertionError(f"serve_main: serve launched K5 {k5_launches} times in "
                                 f"{steps} decode steps of {n_layers} layers, K4 {k4_serve}")
        if plain_calls:
            raise AssertionError(f"serve_main: plain versions ran on the card: {plain_calls}")
    finally:
        for fn in restore:
            fn()
    if res.tokens.shape != (SERVE_ARGS["batch"], SERVE_ARGS["gen"]) or not (
            (res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all():
        raise AssertionError("serve_main: generated tokens out of range")

    # decode steps on their own: host syncs, device-busy share, K5's share
    Bd, P = SERVE_ARGS["batch"], SERVE_ARGS["prompt_len"]
    caches = model.init_decode_caches(Bd, P + SERVE_ARGS["gen"], "cuda")
    prompt = torch.randint(0, cfg.vocab_size, (Bd, P), device="cuda", dtype=torch.int32,
                           generator=torch.Generator(device="cuda").manual_seed(2))
    with torch.no_grad():
        logits, caches = prefill_tokens(model.decode_step, params, caches, prompt)
        tok = logits[:, -1:].argmax(-1).to(torch.int32)
        state = {"caches": caches}

        def step():
            _, state["caches"] = model.decode_step(params, state["caches"], tok)

        syncs = _syncs_in(torch, lambda: [step() for _ in range(2)])
        if syncs:
            raise AssertionError(f"serve_main: decode_step synchronized: {syncs[:3]}")
        d_union, d_window, d_by, d_kernels = _profile(torch, step, 10)
        graph = _graph_decode(torch, model, params, state["caches"], tok, tree_map,
                              param_bytes)
    kv_bytes = 2 * n_layers * Bd * (P + SERVE_ARGS["gen"]) * 4 * 64 * 2

    # prefill/decode consistency (the reference's test_models_smoke.py:89)
    consistency = _prefill_consistency(torch, model, params, tree_map, prefill_tokens)
    decode_ms = res.decode_s * 1e3 / res.gen
    emit({"phase": "serve_main", "ok": True, "arch": cfg.name, "layers": n_layers,
          "params": sum(t.numel() for t in tree_leaves(params)),
          "param_gb": param_bytes / 1e9, "init_s": init_s,
          "prefill": {"batch": B, "seq": S, "k4_launches": k4_launches,
                      "ms": prefill_s * 1e3, "tokens_per_s": B * S / prefill_s,
                      "device_union_ms": p_union / 2, "window_ms": p_window / 2,
                      "k4_share_of_device_time": _share(p_by, "attn_wgmma_kernel")},
          "serve": {**SERVE_ARGS, "k5_launches": k5_launches,
                    "k5_launches_per_step": k5_launches / steps,
                    "prefill_by_decode_s": res.prefill_s,
                    "prefill_by_decode_tokens_per_s": Bd * P / res.prefill_s,
                    "decode_s": res.decode_s, "decode_ms_per_step": decode_ms,
                    "decode_tokens_per_s": Bd * res.gen / res.decode_s,
                    "weight_read_bound_ms_per_step": param_bytes / HBM_BYTES_PER_S * 1e3,
                    "weight_and_kv_bound_ms_per_step":
                        (param_bytes + kv_bytes) / HBM_BYTES_PER_S * 1e3,
                    "peak_mem_gib": peak_gib, "first_tokens": res.tokens[0, :8].tolist()},
          "decode_profile_10_steps": {
              "device_union_ms_per_step": d_union / 10, "window_ms_per_step": d_window / 10,
              "device_busy_share": d_union / d_window,
              "k5_share_of_device_time": _share(d_by, "decode_kernel"),
              "kernels_per_step": d_kernels / 10,
              "top": sorted(((round(ms / 10, 5), name[:80]) for name, ms in d_by.items()),
                            reverse=True)[:8]},
          "host_syncs_in_2_decode_steps": 0, "plain_calls": 0,
          "graph_decode": graph, "consistency": consistency})
    return k4_launches, k5_launches


def _graph_decode(torch, model, params, caches, tok, tree_map, param_bytes, steps=50):
    """One ``model.decode_step`` captured in a ``torch.cuda.CUDAGraph`` (the
    step updates its caches in place and makes no host sync): the replay's
    logits bitwise equal to an eager step's from the same caches and token,
    then ms per step of ``steps`` replays beside ``steps`` eager steps and
    the weight-read bound. A measurement only: the port's serving loop does
    not capture."""
    snap = tree_map(lambda t: t.clone(), caches)

    def restore():
        tree_map(lambda dst, src: dst.copy_(src), caches, snap)

    side = torch.cuda.Stream()  # warm up off the default stream, as capture wants
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            model.decode_step(params, caches, tok)
    torch.cuda.current_stream().wait_stream(side)
    restore()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        logits_g, _ = model.decode_step(params, caches, tok)
    restore()
    eager = model.decode_step(params, caches, tok)[0].clone()
    restore()
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(logits_g, eager):
        raise AssertionError("graph_decode: the replayed step's logits differ from the "
                             f"eager step's (max {float((logits_g - eager).abs().max())})")

    def per_step(fn):
        restore()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / steps

    eager_ms = per_step(lambda: model.decode_step(params, caches, tok))
    graph_ms = per_step(graph.replay)
    eager_ms_2 = per_step(lambda: model.decode_step(params, caches, tok))
    graph_ms_2 = per_step(graph.replay)
    restore()
    return {"batch": int(tok.shape[0]), "steps": steps, "logits_bitwise_equal": True,
            "graph_ms_per_step": [graph_ms, graph_ms_2],
            "eager_ms_per_step": [eager_ms, eager_ms_2],
            "weight_read_bound_ms_per_step": param_bytes / HBM_BYTES_PER_S * 1e3}


def _prefill_consistency(torch, model, params, tree_map, prefill_tokens):
    """Last logits of ``model.prefill`` vs ``prefill_tokens`` over the same
    prompt (2 x 256 tokens): f32 with TF32 off, held to CONSISTENCY_TOL;
    the bf16 gap and top-1 agreement reported beside it."""
    prompt = torch.randint(0, model.cfg.vocab_size, (2, 256), device="cuda",
                           dtype=torch.int32,
                           generator=torch.Generator(device="cuda").manual_seed(3))
    out = {}
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for name, p in (("float32", tree_map(lambda t: t.float(), params)),
                        ("bfloat16", params)):
            with torch.no_grad():
                lp, _ = model.prefill(p, {"tokens": prompt})
                caches = model.init_decode_caches(2, 256, "cuda")
                if name == "float32":
                    caches = tree_map(lambda t: t.float() if t.is_floating_point() else t,
                                      caches)
                ld, _ = prefill_tokens(model.decode_step, p, caches, prompt)
            lp, ld = lp.float(), ld.float()
            gap = float((lp - ld).abs().max())
            out[name] = {"max_abs_gap": gap, "max_abs_logit": float(lp.abs().max()),
                         "top1_agree": float((lp.argmax(-1) == ld.argmax(-1)).float().mean())}
            if name == "float32":
                if not torch.allclose(lp, ld, atol=CONSISTENCY_TOL, rtol=CONSISTENCY_TOL):
                    raise AssertionError(f"{model.cfg.name}: f32 prefill vs prefill_tokens "
                                         f"gap {gap} above {CONSISTENCY_TOL}")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    out["tolerance_f32"] = CONSISTENCY_TOL
    return out


def phase_serve_parity(torch, k4, k5):
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.core.tree import tree_map
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import factory

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(LM_ARCH).reduced()
    model = factory.build(cfg)
    rng = np.random.default_rng(0)
    like = model.init(torch.Generator().manual_seed(0))
    # numpy weights at each leaf's init scale; the norms' ones stay ones
    weights = tree_map(lambda t: t.numpy() if float(t.std()) == 0 else (
        rng.standard_normal(t.shape) * float(t.std())).astype(np.float32), like)
    prompts = rng.integers(0, cfg.vocab_size, (4, 128)).astype(np.int32)
    runs = {}
    before = (k4.launches, k5.launches)
    for dev in ("cpu", "cuda"):
        params = tree_map(lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev),
                          weights)
        with torch.no_grad():
            lp, _ = model.prefill(params, {"tokens": torch.from_numpy(prompts).to(dev)})
        res = serve_mod.serve(cfg, 4, 128, 16, temperature=0.0, device=dev, params=params,
                              prompts=torch.from_numpy(prompts).to(dev))
        runs[dev] = (lp.cpu(), res.prefill_logits.cpu(), res.tokens)
    launched = (k4.launches - before[0], k5.launches - before[1])
    (lp_c, pl_c, tok_c), (lp_g, pl_g, tok_g) = runs["cpu"], runs["cuda"]
    if not np.array_equal(tok_c, tok_g):
        raise AssertionError("serve_parity: greedy tokens differ between card and CPU")
    for name, a, b in (("prefill", lp_g, lp_c), ("prefill_tokens", pl_g, pl_c)):
        if not torch.allclose(a, b, atol=1e-4, rtol=1e-4):
            raise AssertionError(f"serve_parity: {name} logits differ: "
                                 f"{float((a - b).abs().max())}")
    if launched[0] < cfg.num_layers or launched[1] < cfg.num_layers * (128 + 16):
        raise AssertionError(f"serve_parity: K4/K5 launched {launched} times")
    emit({"phase": "serve_parity", "ok": True, "arch": cfg.name, "batch": 4,
          "prompt_len": 128, "gen": 16, "k4_launches": launched[0],
          "k5_launches": launched[1], "tokens_equal": True,
          "max_abs_logit_diff": max(float((lp_g - lp_c).abs().max()),
                                    float((pl_g - pl_c).abs().max())),
          "tf32": False})


def phase_kernel_k3(torch, k3):
    gen = torch.Generator(device="cuda").manual_seed(3)
    n, k = FLEET  # the policy's score: 16 384 integer ages plus [0, 0.5) noise

    def ages(size, high, noise):
        a = torch.randint(0, high, (size,), generator=gen, device="cuda").float()
        return a + torch.rand(size, generator=gen, device="cuda") * 0.5 if noise else a

    zeros = torch.where(torch.rand(n, generator=gen, device="cuda") < 0.5, 0.0, -0.0)
    cases = [("policy", ages(n, 64, True), k), ("policy_int", ages(n, 64, False), k),
             ("example_1M", ages(1_000_000, 50, False), 128),
             ("all_equal", torch.full((n,), 7.0, device="cuda"), k),
             ("k1", ages(50_000, 1000, True), 1), ("k1024", ages(70_001, 50, False), 1024),
             ("n_ragged", ages(2 * 2048 + 3, 10, False), 7),
             ("cohort_15pct", ages(n, 128, True), 2458),
             ("n100000_k15000", ages(100_000, 1000, True), 15_000),
             ("n1M_k150000", ages(1_000_000, 50, True), 150_000),
             ("k_equals_n", ages(40_000, 20, False), 40_000),
             ("signed_zeros", torch.where(torch.rand(n, generator=gen, device="cuda") < 0.05,
                                          1.0, zeros), k),
             ("signed_zeros_k_n", zeros, n)]
    launches_per_call = {}
    for name, a, kk in cases:
        for sorted_ in (True, False):
            before = k3.launches
            out = k3.aoi_topk(a, kk, sorted_)
            plain = k3.topk_plain(a, kk, sorted_)
            torch.cuda.synchronize()
            if not _same_bits(torch, out, plain):
                raise AssertionError(f"K3 disagrees with its plain version: {name}, "
                                     f"sorted={sorted_}")
            if k3.launches - before != 1:
                raise AssertionError(f"K3 counted {k3.launches - before} calls: {name}")
            launches_per_call[f"{name}_{'sorted' if sorted_ else 'unsorted'}"] = k3.plan(
                a.shape[0], kk, sorted_).launches
        if name == "all_equal" and not torch.equal(out[1].cpu(), torch.arange(kk)):
            raise AssertionError("K3 tie order is not lower-index-first")
    if set(launches_per_call.values()) != {1}:
        raise AssertionError(f"K3 plans more than one launch a call: {launches_per_call}")
    a = cases[0][1]
    big = cases[9][1]
    graphs = {f"n{n}_k{k}_unsorted": _graph_replay_equal(
                  torch, lambda: k3.aoi_topk(a, k, False)),
              "n1000000_k150000_sorted": _graph_replay_equal(
                  torch, lambda: k3.aoi_topk(big, 150_000, True))}
    if not all(graphs.values()):
        raise AssertionError(f"K3 graph replay differs from the eager call: {graphs}")
    run = lambda: k3.aoi_topk(a, k, False)  # noqa: E731  (the policy's call)
    run_sorted = lambda: k3.aoi_topk(a, k)  # noqa: E731
    entry = {
        "name": "aoi_topk", "route": "cuda", "source": "src/repro_torch/csrc/aoi_topk.cu",
        "replaces": "src/repro/kernels/aoi_topk.py:42", "max_abs_err": 0.0,
        "ms": cuda_ms(torch, run),
        "plain_ms": cuda_ms(torch, lambda: k3.topk_plain(a, k, False)),
        "bound_ms": _topk_bound_ms(n, k), "bound_by": "bytes",
        "library_ms": cuda_ms(torch, lambda: torch.topk(a, k, sorted=False)),
    }
    ladder = _ladder(torch, lambda x, kk, s: k3.aoi_topk(x, kk, s),
                     lambda x, kk, s: torch.topk(x, kk, sorted=s),
                     lambda size: ages(size, max(2, 2 * size // 2458), True), (False, True))
    emit({"phase": "kernel_k3", "ok": True, "cases": [c[0] for c in cases], "n": n, "k": k,
          "sorted": False, "exact": True, "plan": k3.plan(n, k, False)._asdict(),
          "launches_per_call": launches_per_call, "graph_replay_equal": graphs,
          **entry, "device_ms": device_ms(torch, run),
          "sorted_ms": cuda_ms(torch, run_sorted), "sorted_device_ms": device_ms(torch, run_sorted),
          "plain_device_ms": device_ms(torch, lambda: k3.topk_plain(a, k, False)),
          "library_device_ms": device_ms(torch, lambda: torch.topk(a, k, sorted=False)),
          "ladder": ladder, "policy_1M": _policy_1m(torch, k3)})
    return entry


def _policy_1m(torch, k3, n=1_000_000, k=150_000, steps=3):
    """``make_policy("oldest_age", n, k)``, the paper's 15% cohort at 1M
    clients, stepped on replayed draws on the card and on the CPU: one K3
    launch a step on the card, masks of exactly k, equal to the CPU's plain
    route; then ms a step on the card beside the markov policy's."""
    import numpy as np

    from repro_torch.core import selection
    from repro_torch.core.draws import GeneratorDraws, ReplayDraws

    rng = np.random.default_rng(17)
    init = {"policy_init": rng.permutation(n)}
    step_draws = [{"select": (rng.random(n) * 0.5).astype(np.float32)} for _ in range(steps)]
    policy = selection.make_policy("oldest_age", n, k)
    masks, launched = {}, {}
    for dev in ("cuda", "cpu"):
        draws = ReplayDraws(init, step_draws, dev)
        state = policy.init(draws, n)
        before, rows = k3.launches, []
        for r in range(steps):
            sel, state = policy.step(state, draws.step(r))
            rows.append(sel.cpu())
        launched[dev] = k3.launches - before
        masks[dev] = torch.stack(rows)
    sizes = masks["cuda"].sum(1).tolist()
    if launched["cuda"] != steps or launched["cpu"] != 0:
        raise AssertionError(f"policy_1M: K3 launched {launched} in {steps} steps")
    if sizes != [k] * steps or not torch.equal(masks["cuda"], masks["cpu"]):
        raise AssertionError(f"policy_1M: masks of sizes {sizes} or unequal to the plain route")

    def step_ms(name, reps=10):
        pol = selection.make_policy(name, n, k)
        draws = GeneratorDraws(0, "cuda")
        state = pol.init(draws, n)
        for _ in range(2):
            _, state = pol.step(state, draws)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            _, state = pol.step(state, draws)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    return {"n": n, "k": k, "steps": steps, "k3_launches": launched["cuda"],
            "mask_sizes": sizes, "masks_equal_plain": True,
            "oldest_age_ms_per_step": step_ms("oldest_age"),
            "markov_ms_per_step": step_ms("markov")}


def phase_async_oldest(torch, k3):
    from repro_torch.core import selection
    from repro_torch.engine import run_engine
    from repro_torch.launch import fl_async

    args = fl_async.parse_args(OLDEST_ARGV)
    t0 = time.time()
    task, engine = fl_async.build(args)
    setup_s = time.time() - t0
    captured, masks = {}, []
    finalize, mask = engine.finalize, selection._mask

    def capture(state, *rest):
        captured["state"] = state
        return finalize(state, *rest)

    def recording(n, idx):
        sel = mask(n, idx)
        masks.append(sel.sum())  # on the device: no sync inside the run
        return sel

    engine.finalize = capture
    selection._mask = recording
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k3.launches = 0
        res = run_engine(engine, progress=True)
        launches = k3.launches
    finally:
        selection._mask = mask
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    fl_async.report(res, args)
    cfg = res.config
    off = [p for p, t in _state_tensors(captured["state"])
           if not (isinstance(t, torch.Tensor) and t.is_cuda)]
    if off:
        raise AssertionError(f"async_oldest: engine state off the GPU: {off}")
    if launches != cfg.rounds:
        raise AssertionError(f"async_oldest: K3 launched {launches} times in "
                             f"{cfg.rounds} steps")
    sizes = [int(s) for s in masks]
    if len(sizes) != cfg.rounds or any(s != cfg.k for s in sizes):
        raise AssertionError(f"async_oldest: selection masks of sizes {sizes}, not {cfg.k}")
    evals = [r.eval_loss for r in res.records]
    trains = [r.train_loss for r in res.records if r.buffer_fill > 0]
    if not all(map(math.isfinite, evals + trains)) or len(res.records) != cfg.rounds:
        raise AssertionError(f"async_oldest: non-finite losses: {evals} {trains}")
    out = {"phase": "async_oldest", "ok": True, "argv": OLDEST_ARGV,
           "kernel_launches": launches, "steps": cfg.rounds, "mask_sizes": sizes,
           "steps_per_s": cfg.rounds / res.wall_time_s, "wall_time_s": res.wall_time_s,
           "setup_s": setup_s, "eval_loss": evals[-1], "accuracy": res.records[-1].accuracy,
           "mean_cohort": res.load_stats["mean_cohort"], "peak_mem_gib": peak_gib,
           "tf32": {"cudnn": torch.backends.cudnn.allow_tf32,
                    "matmul": torch.backends.cuda.matmul.allow_tf32}}
    state, syncs = sync_free_steps(torch, engine, captured["state"], cfg.rounds)
    if syncs:
        raise AssertionError(f"async_oldest: a step synchronized with the host: {syncs}")
    out["host_syncs_in_2_steps"] = 0
    out.update(steady_and_profile(torch, engine, state, cfg.rounds + 2, res.wall_time_s,
                                  match="radix_topk_kernel<true"))  # K3: descending
    emit(out)
    return launches


def _ssd_inputs(torch, gen, shape, dtype, strided=True):
    """x, dt, A, B_, C_ on the card at the model's scales: x, B_, C_ sliced
    from one conv-output-shaped (B, S, nh*hd + 2 ds) buffer, as ``ssm_fwd``
    hands them over (or contiguous copies); dt = softplus(N(0, 1) +
    dt_bias); A = -linspace(1, 16), the model's init."""
    import numpy as np

    B, S, nh, hd, ds = shape
    di = nh * hd
    buf = (torch.randn((B, S, di + 2 * ds), generator=gen, device="cuda") * 0.5).to(dtype)
    x = buf[..., :di].reshape(B, S, nh, hd)
    B_, C_ = buf[..., di:di + ds], buf[..., di + ds:]
    if not strided:
        x, B_, C_ = x.contiguous(), B_.contiguous(), C_.contiguous()
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, nh), generator=gen, device="cuda") + float(np.log(np.expm1(0.01))))
    return x, dt, -torch.linspace(1.0, 16.0, nh, device="cuda"), B_, C_


def phase_kernel_k6(torch, k6):
    gen = torch.Generator(device="cuda").manual_seed(6)
    bf16, f32 = torch.bfloat16, torch.float32
    B, S = PREFILL_SHAPE
    main = (B, S, 32, 64, 128)  # mamba2-370m: 32 heads of 64, d_state 128
    cases = [(main, 256, bf16, True), ((1, 512, 4, 64, 128), 256, f32, False),
             ((2, 1024, 8, 64, 128), 256, f32, True), ((2, 64, 8, 32, 16), 16, f32, True),
             ((1, 200, 2, 64, 64), 100, f32, False), ((2, 128, 3, 32, 16), 32, bf16, True),
             # four chunks (each from zero and from h0), and chunks of 64
             ((2, 1024, 8, 64, 128), 256, bf16, True), ((2, 512, 4, 64, 128), 64, bf16, True)]
    errs = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's einsums in f32
    try:
        for shape, chunk, dt_, strided in cases:
            x, dt, A, B_, C_ = _ssd_inputs(torch, gen, shape, dt_, strided)
            h0 = torch.randn(shape[:1] + shape[2:], generator=gen, device="cuda")
            for init in (None, h0):
                y, h = k6.ssd_scan(x, dt, A, B_, C_, chunk, init)
                again = k6.ssd_scan(x, dt, A, B_, C_, chunk, init)
                y_p, h_p = k6.ssd_chunked_plain(x, dt, A, B_, C_, chunk, init)
                torch.cuda.synchronize()
                name = f"{shape}_L{chunk}_{str(dt_)[6:]}{'_h0' if init is not None else ''}"
                if not (torch.equal(y, again[0]) and torch.equal(h, again[1])):
                    raise AssertionError(f"K6 launches differ bitwise: {name}")
                for what, got, exp in (("y", y, y_p), ("h_final", h, h_p)):
                    if not torch.allclose(got, exp, atol=K6_TOL, rtol=K6_TOL):
                        raise AssertionError(
                            f"K6 {what} disagrees with its plain version: {name} "
                            f"(max abs err {float((got - exp).abs().max())})")
                errs[name] = {"y": float((y - y_p).abs().max()),
                              "h_final": float((h - h_p).abs().max())}
        x, dt, A, B_, C_ = _ssd_inputs(torch, gen, main, bf16)
        run = lambda: k6.ssd_scan(x, dt, A, B_, C_, 256)  # noqa: E731
        plain = lambda: k6.ssd_chunked_plain(x, dt, A, B_, C_, 256)  # noqa: E731
        Bm, Sm, nh, hd, ds = main
        L, nc = 256, Sm // 256
        # the FMA schedule (the f32 route's kernel): the scores once per head
        fma_ops = k6.cost(Bm, Sm, nh, hd, ds, L, f32)[0]
        # the tensor-core schedule: CB^T once per (b, chunk), exact in bf16;
        # then per (b, head, chunk) the chunk state, C h_in^T and the causal
        # scores times x, each once per bf16 term of its f32 operand; y and
        # h_final out in f32
        ops, *rw = k6.cost(Bm, Sm, nh, hd, ds, L, bf16)
        nbytes = sum(rw)
        # the schedule's workspace, beside the bound: chunk states (f32)
        # written and read, the entering states (bf16 terms) written and
        # read, CB^T written and read
        n_states = Bm * nh * nc * hd * ds
        ws_bytes = 2 * n_states * 4 + 2 * n_states * 2 * k6.BF16_TERMS \
            + 2 * Bm * nc * L * L * 4
        bound_s = max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S)
        entry = {
            "name": "ssd_scan", "route": "cuda", "source": "src/repro_torch/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:75",
            "max_abs_err": max(max(e.values()) for e in errs.values()),
            "ms": cuda_ms(torch, run, calls=20), "plain_ms": cuda_ms(torch, plain, calls=3,
                                                                     trials=3),
            "bound_ms": bound_s * 1e3,
            "bound_by": "operations" if ops / BF16_OPS_PER_S > nbytes / HBM_BYTES_PER_S
            else "bytes",
            "library_ms": None,  # no single PyTorch call computes the scan
        }
        dev_ms = device_ms(torch, run)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    emit({"phase": "kernel_k6", "ok": True, "cases": len(errs), "shape": list(main),
          "chunk": 256, "dtype": "bfloat16", "inputs": "strided slices of (B, S, 2304)",
          "tolerance": K6_TOL, "phases": k6.PHASES, "bf16_terms": k6.BF16_TERMS, **entry,
          "device_ms": dev_ms, "workspace_bound_ms": max(
              (nbytes + ws_bytes) / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3,
          "fma_bound_ms": max(nbytes / HBM_BYTES_PER_S,
                                                   fma_ops / FP32_OPS_PER_S) * 1e3,
          "gflop": ops / 1e9, "fma_gflop": fma_ops / 1e9, "mbytes": nbytes / 1e6,
          "workspace_mbytes": ws_bytes / 1e6, "tflops": ops / (dev_ms * 1e-3) / 1e12,
          "ctas_per_phase": [Bm * nc * (L // 64) * (L // 64 + 1) // 2, Bm * nh * nc,
                             Bm * nh * -(-hd * ds // 1024), Bm * nh * nc],
          "sms": torch.cuda.get_device_properties(0).multi_processor_count,
          "max_abs_err_by_case": errs})
    return entry


def phase_ssm_serve_main(torch, k6):
    from repro_torch.configs import get_arch
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import factory
    from repro_torch.serve.batching import prefill_tokens

    cfg = get_arch(SSM_ARCH)
    model = factory.build(cfg)
    n_layers = cfg.num_layers
    t0 = time.time()
    params = model.init(torch.Generator(device="cuda").manual_seed(SSM_SERVE_ARGS["seed"]))
    torch.cuda.synchronize()
    init_s = time.time() - t0
    param_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    B, S = PREFILL_SHAPE
    toks = torch.randint(0, cfg.vocab_size, (B, S), device="cuda", dtype=torch.int32,
                         generator=torch.Generator(device="cuda").manual_seed(1))
    plain_calls = {}
    restore = _count_calls(k6, ["ssd_chunked_plain"], plain_calls)
    try:
        with torch.no_grad():
            prefill = lambda: model.prefill(params, {"tokens": toks})  # noqa: E731
            prefill()  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            k6.launches = 0
            t0 = time.perf_counter()
            logits, caches = prefill()
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            k6_launches = k6.launches
            prefill_peak = torch.cuda.max_memory_allocated() / 2**30
            if not bool(torch.isfinite(logits).all()) or logits.shape != (B, 1, cfg.vocab_size):
                raise AssertionError("ssm_serve_main: prefill logits not finite / of shape")
            h = caches["blocks"][0]["h"]
            if h.shape != (n_layers, B, 32, 64, 128) or not bool(torch.isfinite(h).all()):
                raise AssertionError(f"ssm_serve_main: prefill state {tuple(h.shape)}")
            if k6_launches != n_layers:
                raise AssertionError(f"ssm_serve_main: model.prefill launched K6 "
                                     f"{k6_launches} times ({n_layers} layers)")
            del caches
            p_union, p_window, p_by, p_kernels = _profile(torch, prefill, 2)
            torch.cuda.reset_peak_memory_stats()
            k6.launches = 0
            res = serve_mod.serve(cfg, device="cuda", params=params, **SSM_SERVE_ARGS)
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
            k6_serve = k6.launches
        if k6_serve:
            raise AssertionError(f"ssm_serve_main: serve launched K6 {k6_serve} times "
                                 f"(its prompt goes through prefill_tokens)")
        if plain_calls:
            raise AssertionError(f"ssm_serve_main: the plain scan ran on the card: "
                                 f"{plain_calls}")
    finally:
        restore()
    if res.tokens.shape != (SSM_SERVE_ARGS["batch"], SSM_SERVE_ARGS["gen"]) or not (
            (res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all():
        raise AssertionError("ssm_serve_main: generated tokens out of range")

    # decode steps on their own: host syncs, device-busy share, launches a step
    Bd, P = SSM_SERVE_ARGS["batch"], SSM_SERVE_ARGS["prompt_len"]
    caches = model.init_decode_caches(Bd, P + SSM_SERVE_ARGS["gen"], "cuda")
    prompt = torch.randint(0, cfg.vocab_size, (Bd, 8), device="cuda", dtype=torch.int32,
                           generator=torch.Generator(device="cuda").manual_seed(2))
    with torch.no_grad():
        logits, caches = prefill_tokens(model.decode_step, params, caches, prompt)
        tok = logits[:, -1:].argmax(-1).to(torch.int32)
        state = {"caches": caches}

        def step():
            _, state["caches"] = model.decode_step(params, state["caches"], tok)

        syncs = _syncs_in(torch, lambda: [step() for _ in range(2)])
        if syncs:
            raise AssertionError(f"ssm_serve_main: decode_step synchronized: {syncs[:3]}")
        d_union, d_window, d_by, d_kernels = _profile(torch, step, 10)
    state_bytes = n_layers * Bd * (32 * 64 * 128 * 4 * 2 + 3 * 2304 * 2 * 2)  # h, conv r+w
    decode_ms = res.decode_s * 1e3 / res.gen
    emit({"phase": "ssm_serve_main", "ok": True, "arch": cfg.name, "layers": n_layers,
          "params": sum(t.numel() for t in tree_leaves(params)),
          "param_gb": param_bytes / 1e9, "init_s": init_s,
          "prefill": {"batch": B, "seq": S, "k6_launches": k6_launches,
                      "ms": prefill_s * 1e3, "tokens_per_s": B * S / prefill_s,
                      "peak_mem_gib": prefill_peak,
                      "device_union_ms": p_union / 2, "window_ms": p_window / 2,
                      "kernels_per_call": p_kernels / 2,
                      "k6_share_of_device_time": _share(p_by, "ssd_"),
                      "top": sorted(((round(ms / 2, 4), name[:80]) for name, ms in
                                     p_by.items()), reverse=True)[:8]},
          "serve": {**SSM_SERVE_ARGS, "k6_launches": k6_serve,
                    "prefill_by_decode_s": res.prefill_s,
                    "prefill_by_decode_tokens_per_s": Bd * P / res.prefill_s,
                    "decode_s": res.decode_s, "decode_ms_per_step": decode_ms,
                    "decode_tokens_per_s": Bd * res.gen / res.decode_s,
                    "weight_read_bound_ms_per_step": param_bytes / HBM_BYTES_PER_S * 1e3,
                    "weight_and_state_bound_ms_per_step":
                        (param_bytes + state_bytes) / HBM_BYTES_PER_S * 1e3,
                    "peak_mem_gib": peak_gib, "first_tokens": res.tokens[0, :8].tolist()},
          "decode_profile_10_steps": {
              "device_union_ms_per_step": d_union / 10, "window_ms_per_step": d_window / 10,
              "device_busy_share": d_union / d_window, "kernels_per_step": d_kernels / 10,
              "top": sorted(((round(ms / 10, 5), name[:80]) for name, ms in d_by.items()),
                            reverse=True)[:8]},
          "host_syncs_in_2_decode_steps": 0, "plain_calls": 0})
    return k6_launches, model, params


def phase_ssm_parity(torch, k6, model, params):
    """The reference's prefill/decode contract on mamba2: the reduced model
    in f32 (TF32 off) on the card, ``model.prefill`` (K6) against
    ``prefill_tokens`` (the decode recurrence) for logits and the SSM
    state, and against the CPU's plain route; then mamba2-370m at full
    width, f32 held to CONSISTENCY_TOL and bf16's top-1 agreement."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.models import factory
    from repro_torch.serve.batching import prefill_tokens

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(SSM_ARCH).reduced()
    small = factory.build(cfg)
    weights = small.init(torch.Generator().manual_seed(0))  # on the CPU, then copied
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 128))
    out, before = {}, k6.launches
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), weights)
        toks = torch.from_numpy(prompts.astype(np.int32)).to(dev)
        with torch.no_grad():
            lp, cp = small.prefill(p, {"tokens": toks})
            ld, cd = prefill_tokens(small.decode_step, p, small.init_decode_caches(4, 128, dev),
                                    toks)
        out[dev] = {"prefill": lp.cpu(), "h": cp["blocks"][0]["h"].cpu(),
                    "conv": cp["blocks"][0]["conv"].cpu(), "decode": ld.cpu(),
                    "h_decode": cd["blocks"][0]["h"].cpu(),
                    "conv_decode": cd["blocks"][0]["conv"].cpu()}
    launched = k6.launches - before
    if launched != cfg.num_layers:
        raise AssertionError(f"ssm_parity: K6 launched {launched} times on the card")
    gaps = {}
    g = out["cuda"]
    for name, a, b, tol in (("prefill_vs_prefill_tokens", g["prefill"], g["decode"], 3e-4),
                            ("h_vs_decode", g["h"], g["h_decode"], 1e-4),
                            ("conv_vs_decode", g["conv"], g["conv_decode"], 1e-4),
                            ("prefill_card_vs_cpu", g["prefill"], out["cpu"]["prefill"], 1e-4),
                            ("h_card_vs_cpu", g["h"], out["cpu"]["h"], 1e-4)):
        gaps[name] = float((a - b).abs().max())
        if not torch.allclose(a, b, atol=tol, rtol=tol):
            raise AssertionError(f"ssm_parity: {name} gap {gaps[name]} above {tol}")
    consistency = _prefill_consistency(torch, model, params, tree_map, prefill_tokens)
    emit({"phase": "ssm_parity", "ok": True, "arch": cfg.name, "batch": 4,
          "prompt_len": 128, "k6_launches": launched, "max_abs_gap": gaps,
          "full_width": {"arch": model.cfg.name, **consistency},
          "params_reduced": sum(t.numel() for t in tree_leaves(weights)), "tf32": False})


# ---------------------------------------------------------------------------
# slice H: the serving tier (version store, routers, slot pool, serving loop,
# train-and-serve driver)
# ---------------------------------------------------------------------------


def _ring_store(torch, params, h):
    """The reference test's ring (``tests/test_serve.py``): slot v holds
    version v's params times 1 + 0.01 v, versions 0 .. h - 1, head h - 1."""
    from repro_torch.core.tree import tree_map
    from repro_torch.serve import VersionStore

    hist = tree_map(lambda p: torch.stack([p * (1.0 + 0.01 * v) for v in range(h)]), params)
    version = torch.tensor(h - 1, dtype=torch.int32, device=hist["embed"].device)
    return VersionStore(hist, version, h)


def _solo_tokens(model, store, req, version, slots, ctx, device):
    """``req`` decoded alone in a one-replica pool of ``slots`` slots pinned
    to ``version``: the join/evict contract's reference."""
    from repro_torch.serve import ReplicaPool

    pool = ReplicaPool(model, 1, slots, ctx, device=device)
    pool.params[0] = store.read(version).params
    done, t = pool.join(0, req, 0), 0
    while done is None:
        finished = pool.decode_tick(t)
        done, t = (finished[0] if finished else None), t + 1
    return done.tokens


def serve_contracts(model, store, device):
    """serve_loop (a): round_robin over 2 replicas x SERVE_CONTRACT's slots,
    six requests that join and leave around each other, each stream's
    tokens bitwise its decode alone in a pool of the same width on the same
    version, Var[X] = 0 and E[X] = 2; then SERVE_CRASH's replicas at
    stagger 0 under ``replica_crash``: every stream completes and the
    tokens equal the calm run's. Returns what it checked."""
    import numpy as np

    from repro_torch.faults import make_fault
    from repro_torch.serve import Request, run_serve_loop

    n, P, slots = (SERVE_CONTRACT[k] for k in ("requests", "prompt_len", "slots"))
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, tick=i, prompt=rng.integers(0, model.cfg.vocab_size, P)
                    .astype(np.int32), gen_len=3 + i % 3) for i in range(n)]
    ctx = P + 5
    churn = run_serve_loop(model, store, reqs, router="round_robin", n_replicas=2,
                           slots=slots, ctx=ctx, device=device)
    if len(churn.results) != n or churn.queue_left:
        raise AssertionError(f"serve_loop: {len(churn.results)} of {n} streams served")
    for res in churn.results:
        solo = _solo_tokens(model, store, reqs[res.rid], res.version, slots, ctx, device)
        if res.tokens != solo:
            raise AssertionError(f"serve_loop: stream {res.rid} {res.tokens} differs from "
                                 f"its solo decode {solo}")
    ss = churn.serve_stats
    if ss["var_X"] != 0.0 or ss["mean_X"] != 2.0:
        raise AssertionError(f"serve_loop: round_robin Var[X] {ss['var_X']} E[X] {ss['mean_X']}")
    kw = dict(router="round_robin", n_replicas=SERVE_CRASH["n_replicas"], slots=slots,
              ctx=ctx, stagger=0, seed=SERVE_CRASH["seed"], device=device)
    calm = run_serve_loop(model, store, reqs, **kw)
    chaos = run_serve_loop(model, store, reqs, faults=[make_fault(
        "replica_crash", SERVE_CRASH["n_replicas"], SERVE_CRASH["rate"])], **kw)
    cs = chaos.serve_stats
    if cs["crashes"] == 0 or cs["failed_over"] == 0:
        raise AssertionError(f"serve_loop: the crash run crashed nothing: {cs}")
    if len(chaos.results) != n or chaos.queue_left:
        raise AssertionError(f"serve_loop: {len(chaos.results)} of {n} streams survived")
    calm_tokens = {r.rid: r.tokens for r in calm.results}
    for res in chaos.results:
        if res.tokens != calm_tokens[res.rid]:
            raise AssertionError(f"serve_loop: stream {res.rid} diverged across failover")
    return {"streams": n, "prompt_len": P, "slots": slots, "bitwise_vs_solo": True,
            "stalenesses": sorted({r.staleness for r in churn.results}),
            "var_X": ss["var_X"], "mean_X": ss["mean_X"],
            "crash": {"crashes": cs["crashes"], "failed_over": cs["failed_over"],
                      "migrations": sum(r.migrations for r in chaos.results),
                      "tokens_equal_calm": True}}


def serve_trace(model, store, device, pool=None):
    """serve_loop (b): SERVE_TRACE's request trace (``sample_requests`` under
    the lognormal profile) through the markov router; returns the trace, the
    pool and the report."""
    from repro_torch.core.draws import GeneratorDraws
    from repro_torch.serve import ReplicaPool, run_serve_loop
    from repro_torch.sim import arrivals, get_profile

    tr = SERVE_TRACE
    proc = arrivals.from_profile(get_profile(tr["profile"]), tr["rate"], tr["prompt_len"],
                                 tr["gen_len"])
    reqs = arrivals.sample_requests(GeneratorDraws(tr["seed"], "cpu"), proc, tr["ticks"],
                                    model.cfg.vocab_size)
    if pool is None:
        pool = ReplicaPool(model, tr["n_replicas"], tr["slots"],
                           tr["prompt_len"] + 2 * tr["gen_len"], device=device)
        pool.refresh(store)
    report = run_serve_loop(model, store, reqs, router=tr["router"], pool=pool,
                            seed=tr["seed"])
    if len(report.results) != len(reqs) or report.queue_left:
        raise AssertionError(f"serve_loop: {len(report.results)} of {len(reqs)} streams "
                             "served")
    return reqs, pool, report


def phase_serve_loop(torch, k5):
    from repro_torch.configs import get_arch
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.models import factory, transformer

    t_phase = time.time()
    cfg = get_arch(LM_ARCH)
    model = factory.build(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    store = _ring_store(torch, params, SERVE_RING_H)
    del params
    ring_gb = sum(t.numel() * t.element_size() for t in tree_leaves(store.hist)) / 1e9
    counts, plain = {}, {}
    restore = [_count_calls(transformer, ["decode_step"], counts),
               _count_calls(k5, ["flash_decode_plain"], plain)]
    try:
        k5.launches = 0
        contracts = serve_contracts(model, store, "cuda")
        steps_a, k5_a = counts.pop("decode_step"), k5.launches
        if k5_a != cfg.num_layers * steps_a:
            raise AssertionError(f"serve_loop: K5 launched {k5_a} times in {steps_a} decode "
                                 f"steps of {cfg.num_layers} layers (contracts)")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k5.launches = 0
        t0 = time.perf_counter()
        reqs, pool, rep = serve_trace(model, store, "cuda")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        steps_b, k5_b = counts.pop("decode_step"), k5.launches
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        if k5_b != cfg.num_layers * steps_b:
            raise AssertionError(f"serve_loop: K5 launched {k5_b} times in {steps_b} decode "
                                 f"steps of {cfg.num_layers} layers (timed run)")
        if plain:
            raise AssertionError(f"serve_loop: plain versions ran on the card: {plain}")
    finally:
        for fn in restore:
            fn()
    toks = [t for r in rep.results for t in r.tokens]
    if min(toks) < 0 or max(toks) >= cfg.vocab_size:
        raise AssertionError("serve_loop: tokens out of range")
    joins = len(reqs)
    ticks_busy = steps_b - joins * SERVE_TRACE["prompt_len"]  # pool ticks of busy replicas
    # the pool tick alone (8 rows of one replica): device-busy share, and a
    # CUDA-graph replay of it against eager ticks (``_graph_decode``)
    tick_pool, params0 = pool.pools[0], pool.params[0]
    tok = torch.randint(0, cfg.vocab_size, (SERVE_TRACE["slots"], 1), device="cuda",
                        dtype=torch.int32, generator=torch.Generator(device="cuda").manual_seed(4))
    with torch.no_grad():
        state = {"pool": tick_pool}

        def tick():
            _, state["pool"] = model.decode_step(params0, state["pool"], tok)

        d_union, d_window, d_by, d_kernels = _profile(torch, tick, 10)
        syncs = _syncs_in(torch, lambda: [tick() for _ in range(2)])
        if syncs:
            raise AssertionError(f"serve_loop: the pool tick synchronized: {syncs[:3]}")
        graph = _graph_decode(torch, model, params0, tick_pool, tok, tree_map,
                              sum(t.numel() * t.element_size()
                                  for t in tree_leaves(params0)))
    ss = rep.serve_stats
    emit({"phase": "serve_loop", "ok": True, "arch": cfg.name, "layers": cfg.num_layers,
          "dtype": cfg.param_dtype, "ring_versions": SERVE_RING_H, "ring_gb": ring_gb,
          "contracts": {**contracts, "decode_steps": steps_a, "k5_launches": k5_a},
          "trace": {**SERVE_TRACE, "requests": joins, "ticks_run": rep.ticks,
                    "decisions": rep.decisions, "rejections": rep.rejections,
                    "tokens_out": rep.tokens_out, "decode_steps": steps_b,
                    "pool_ticks": ticks_busy, "join_decode_steps": joins * SERVE_TRACE[
                        "prompt_len"], "k5_launches": k5_b, "run_s": run_s,
                    "ms_per_tick": rep.wall_s * 1e3 / rep.ticks,
                    "decode_ms_per_tick": rep.decode_wall_s * 1e3 / rep.ticks,
                    "decode_tokens_per_s": rep.tok_s, "ttft_ticks_mean": rep.ttft_ticks_mean,
                    "ttft_ms_mean": rep.ttft_s_mean * 1e3,
                    "staleness_mean": rep.staleness_mean, "staleness_max": rep.staleness_max,
                    "var_X": ss["var_X"], "mean_X": ss["mean_X"],
                    "replica_mean_X": ss["replica_mean_X"],
                    "host_reads": pool.host_reads,
                    "host_reads_per_tick": pool.host_reads / rep.ticks,
                    "peak_mem_gib": peak_gib},
          "pool_tick_profile_10": {
              "device_union_ms_per_tick": d_union / 10, "window_ms_per_tick": d_window / 10,
              "device_busy_share": d_union / d_window,
              "k5_share_of_device_time": _share(d_by, "decode_kernel"),
              "kernels_per_tick": d_kernels / 10},
          "host_syncs_in_2_pool_ticks": 0, "pool_tick_graph": graph,
          "seconds": time.time() - t_phase})
    return k5_b


def phase_serve_fleet(torch, k5):
    """``repro_torch.launch.serve_fleet.main`` at the reference's defaults,
    then with ``--crash-rate 0.1``: every chunk's head read bitwise the
    engine's live params, finite losses, every stream served, K5 launched
    once per layer per decode step. Returns the default run's K5 count."""
    import math as _math

    from repro_torch.configs import get_arch
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch import serve_fleet as sf
    from repro_torch.models import transformer

    t_phase = time.time()
    layers = get_arch(LM_ARCH).reduced().num_layers
    rec = {}
    saved = (sf.VersionStore, sf.AsyncEngine, sf.run_serve_loop)
    real_store, real_engine, real_loop = saved

    class CheckedStore(real_store):
        @classmethod
        def from_engine(cls, engine, state):
            store = real_store.from_engine(engine, state)
            head = store.read(store.latest).params
            rec["heads"].append(all(torch.equal(a, b) for a, b in zip(
                tree_leaves(head), tree_leaves(state["params"]))))
            return store

    class RecordedEngine(real_engine):
        def run_chunk(self, state, r0, length, with_history):
            state, aux = super().run_chunk(state, r0, length, with_history)
            rec["losses"].extend(aux["loss"].tolist())
            return state, aux

    def recorded_loop(model, store, reqs, **kw):
        report = real_loop(model, store, reqs, **kw)
        rec["served"].append((len(reqs), len(report.results), report.queue_left))
        return report

    runs, counts = {}, {}
    restore = _count_calls(transformer, ["decode_step"], counts)
    sf.VersionStore, sf.AsyncEngine, sf.run_serve_loop = (CheckedStore, RecordedEngine,
                                                          recorded_loop)
    try:
        for name, extra in (("defaults", []), ("crash_rate_0.1", ["--crash-rate", "0.1"])):
            rec.update(heads=[], losses=[], served=[])
            counts.clear()
            k5.launches = 0
            t0 = time.perf_counter()
            summary = sf.main(SERVE_FLEET_ARGV + extra)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            steps, launched = counts.get("decode_step", 0), k5.launches
            if not rec["heads"] or not all(rec["heads"]):
                raise AssertionError(f"serve_fleet {name}: a head read differs from the "
                                     "engine's params")
            if not all(_math.isfinite(x) for x in rec["losses"]):
                raise AssertionError(f"serve_fleet {name}: losses {rec['losses']}")
            if any(n != got or left for n, got, left in rec["served"]):
                raise AssertionError(f"serve_fleet {name}: streams dropped {rec['served']}")
            if not launched or launched != layers * steps:
                raise AssertionError(f"serve_fleet {name}: K5 launched {launched} times in "
                                     f"{steps} decode steps of {layers} layers")
            crashes = sum(s["crashes"] for s in summary["serve_stats"])
            if extra and not crashes:
                raise AssertionError(f"serve_fleet {name}: no replica crashed")
            runs[name] = {"run_s": run_s, "decode_steps": steps, "k5_launches": launched,
                          "losses": rec["losses"], "head_reads_bitwise": len(rec["heads"]),
                          "requests": sum(n for n, _, _ in rec["served"]),
                          "crashes": crashes,
                          "failed_over": sum(s["failed_over"] for s in summary["serve_stats"]),
                          "summary": {k: v for k, v in summary.items() if k != "cli_args"}}
    finally:
        sf.VersionStore, sf.AsyncEngine, sf.run_serve_loop = saved
        restore()
    emit({"phase": "serve_fleet", "ok": True, "argv": SERVE_FLEET_ARGV, "layers": layers,
          **runs, "seconds": time.time() - t_phase})
    return runs["defaults"]["k5_launches"]


# ---------------------------------------------------------------------------
# slice G2: LM training (K4's backward, sgd_train_step, the train driver, the
# LM as the FL workload)
# ---------------------------------------------------------------------------

TRAIN_SHAPE = (4, 2048)  # (B, S) of lm_train: tinyllama-1.1b's training batch
LM_TRAIN_STEPS = 5
LM_TRAIN_LR = 3e-3
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # relative to each gradient's max
LSE_TOL = {"atol": 1e-4, "rtol": 1e-5}  # the forward's lse against the plain one
TRAIN_ARGV = ["--device", "cuda", "--arch", LM_ARCH, "--target-params", "20e6",
              "--batch", "8", "--seq", "128", "--lr", "3e-3", "--steps", "200",
              "--log-every", "50"]
FL_LM_SYNC_ARGV = ["--device", "cuda", "--arch", LM_ARCH, "--clients", "100", "--k", "15",
                   "--m", "10", "--local-epochs", "5", "--batch-size", "50", "--rounds", "10"]
FL_LM_ASYNC_ARGV = ["--device", "cuda", "--arch", LM_ARCH, "--clients", "16384",
                    "--k", "256", "--rounds", "5"]
K4_BWD_KERNELS = ("dkdv_wgmma_kernel", "dq_wgmma_kernel", "prep_kernel")
# K4's backward before its redesign (mma.sync, synchronous loads): chip run 5
# of this script at the training shape (NVIDIA H100 80GB HBM3, 700.00 W)
K4_BWD_MMA_SYNC_MS = {"ms": 1.474, "device_ms": 1.452}


def _rel_err(got, exp) -> float:
    """max |got - exp| over max |exp|: a gradient's error at its own scale."""
    return float((got.float() - exp.float()).abs().max() / exp.float().abs().max())


def _check_lse(torch, k4, name, q, k, v, out, lse, kw, dt):
    """The forward's ``lse`` against the plain log-sum-exp of the inputs in
    f32 (LSE_TOL; the kernel's scores are f32 sums of exact products, the
    plain bf16 einsum would round them to bf16) and its ``out`` against the
    plain output at ATTN_TOL. Returns the plain lse, which the backward's
    plain version then uses, so a wrong kernel lse shows in the gradients."""
    _, lse_plain = k4.flash_attention_plain(q.float(), k.float(), v.float(), **kw,
                                            return_lse=True)
    if not torch.allclose(lse, lse_plain, **LSE_TOL):
        raise AssertionError(f"K4 {name}: lse off the plain one by "
                             f"{float((lse - lse_plain).abs().max())} ({LSE_TOL})")
    tol = ATTN_TOL[str(dt)[6:]]
    if not torch.allclose(out.float(), k4.flash_attention_plain(q, k, v, **kw).float(),
                          atol=tol, rtol=tol):
        raise AssertionError(f"K4 {name}: the forward with lse disagrees with its plain version")
    return lse_plain


def phase_kernel_k4_bwd(torch, k4):
    """K4's backward kernel, given the forward's ``out`` and ``lse``, against
    ``flash_attention_bwd_plain`` given the same ``out`` and the plain lse
    (dq, dk, dv within BWD_TOL of each gradient's max), at the training
    shape, the forward phase's grid and f32 at the reference's test
    shapes; the forward's lse within LSE_TOL of the plain one and its
    output bitwise the same with and without lse; two launches bitwise
    equal (three at the training shape); ``vmap(grad)`` over a cohort of 4
    bitwise equal to four single calls; its time beside its bound, the
    plain version's, the backward of ``scaled_dot_product_attention`` and
    the ``mma.sync`` design it replaced; its workspace (each of its three
    kernels' device time a launch is ``lm_train``'s, at the same shape)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(14)
    bf16, f32 = torch.bfloat16, torch.float32
    B, S = TRAIN_SHAPE
    main = (B, 4, 8, S, 64)  # tinyllama-1.1b: 4 kv heads, 8 query heads each, D 64
    cases = [(main, "full", 0, bf16, "model")]
    cases += [((1, 2, G, 384, D), "full", 0, bf16, "model")
              for D in (32, 64, 128) for G in (1, 2, 4, 5, 8, 16)]
    cases += [((1, 2, 4, 200, 64), "full", 0, bf16, "model")]
    cases += [((1, 2, G, Sx, D), kind, w, bf16, "model")
              for kind in ("sliding", "chunked") for w in (100, 128)
              for G, Sx, D in ((4, 384, 64), (5, 200, 32), (8, 2048, 128))]
    cases += [(G3_K4_SHAPE, "sliding", G3_WINDOW, dt, layout)  # gemma3's training
              for dt, layout in ((bf16, "model"), (f32, "contiguous"))]
    cases += [(shape, kind, w, f32, "contiguous") for shape, kind, w in [
        ((1, 2, 2, 256, 64), "full", 0), ((2, 1, 4, 512, 32), "full", 0),
        ((1, 2, 1, 512, 128), "sliding", 128), ((1, 1, 2, 512, 64), "chunked", 128),
        ((1, 4, 8, 256, 64), "full", 0)]]
    errs = {}
    for shape, kind, w, dt, layout in cases:
        q, k, v = (_model_layout(torch, gen, shape, dt) if layout == "model"
                   else _attn_inputs(torch, gen, shape, dt))
        dout = torch.randn(q.shape, generator=gen, device="cuda").to(dt)
        kw = dict(scale=shape[-1] ** -0.5, kind=kind, window=w)
        name = f"{tuple(shape)}_{kind}{w or ''}_{str(dt)[6:]}_{layout}"
        out, lse = k4.flash_attention_with_lse(q, k, v, **kw)
        if not torch.equal(out, k4.flash_attention(q, k, v, **kw, block_q=shape[3],
                                                   block_k=shape[3])):
            raise AssertionError(f"K4 {name}: the output's bits move with lse")
        lse_plain = _check_lse(torch, k4, name, q, k, v, out, lse, kw, dt)
        grads = k4.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        again = k4.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        plain = k4.flash_attention_bwd_plain(q, k, v, out, lse_plain, dout, **kw)
        torch.cuda.synchronize()
        tol = BWD_TOL[str(dt)[6:]]
        errs[name] = {"lse_abs": float((lse - lse_plain).abs().max())}
        for g_name, g, a, p in zip(("dq", "dk", "dv"), grads, again, plain):
            if not torch.equal(g, a):
                raise AssertionError(f"K4 bwd {name}: {g_name} launches differ bitwise")
            errs[name][g_name] = _rel_err(g, p)
            if errs[name][g_name] > tol:
                raise AssertionError(f"K4 bwd {name}: {g_name} off its plain version by "
                                     f"{errs[name][g_name]} of its max (tol {tol})")
        del plain

    # vmap(grad) over a cohort of 4, as the FL clients train
    qs, ks, vs = (torch.stack(t) for t in zip(*[_model_layout(torch, gen, (1, 2, 4, 256, 64),
                                                              bf16) for _ in range(4)]))

    def loss(q_, k_, v_):
        return k4.flash_attention(q_, k_, v_, scale=0.125).float().square().sum()

    grad = torch.func.grad(loss, argnums=(0, 1, 2))
    before = k4.bwd_launches
    batched = torch.func.vmap(grad)(qs, ks, vs)
    if k4.bwd_launches != before + 1:
        raise AssertionError("vmap(grad): the cohort was not one backward launch")
    for i in range(4):
        if not all(torch.equal(b[i], s) for b, s in zip(batched, grad(qs[i], ks[i], vs[i]))):
            raise AssertionError(f"vmap(grad) slot {i} differs from its single call")

    # timing at the training shape, in the model's layout
    q, k, v = _model_layout(torch, gen, main, bf16)
    dout = torch.randn(q.shape, generator=gen, device="cuda").to(bf16)
    out, lse = k4.flash_attention_with_lse(q, k, v, scale=0.125)
    lse_plain = k4.flash_attention_plain(q.float(), k.float(), v.float(), scale=0.125,
                                         return_lse=True)[1]
    run = lambda: k4.flash_attention_bwd(q, k, v, out, lse, dout, scale=0.125)  # noqa: E731
    _, Hk, G, _, D = main
    qh = q.reshape(B, Hk * G, S, D).detach().requires_grad_()
    kh, vh = (t.repeat_interleave(G, dim=1).detach().requires_grad_() for t in (k, v))
    o_lib = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
    do_lib = dout.reshape(B, Hk * G, S, D)
    lib = lambda: torch.autograd.grad(o_lib, (qh, kh, vh), do_lib,  # noqa: E731
                                      retain_graph=True)
    # S, dP recomputed; dV, dQ, dK: 5 products; q o do dq, k v dk dv, lse
    ops, *rw = k4.cost(B, Hk, G, S, D, bf16, backward=True)
    nbytes = sum(rw)
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3
    k4.bwd_launches, timed = 0, cuda_ms(torch, run, calls=10, trials=5)
    entry = {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:92",
        "max_abs_err": max(
            float((g.float() - p.float()).abs().max()) for g, p in zip(
                run(), k4.flash_attention_bwd_plain(q, k, v, out, lse_plain, dout, 0.125))),
        "ms": timed,
        "plain_ms": cuda_ms(torch, lambda: k4.flash_attention_bwd_plain(
            q, k, v, out, lse, dout, 0.125), calls=2, trials=3, warmup=1),
        "bound_ms": bound_ms,
        "bound_by": "operations" if ops / BF16_OPS_PER_S > nbytes / HBM_BYTES_PER_S
        else "bytes",
        "library_ms": cuda_ms(torch, lib, calls=10, trials=5),
    }
    k4.bwd_launches = 0
    dev_ms = device_ms(torch, run)
    # three launches at the training shape give the same bits
    first, *again = (run() for _ in range(3))
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for other in again for a, b in zip(first, other)):
        raise AssertionError("K4 bwd: three launches at the training shape differ bitwise")
    k4.bwd_launches = 0
    plan = k4.bwd_plan(*main, sms=torch.cuda.get_device_properties(0).multi_processor_count)
    emit({"phase": "kernel_k4_bwd", "ok": True, "cases": len(cases), "shape": list(main),
          "dtype": "bfloat16", "layout": "model", **entry, "device_ms": dev_ms,
          "library_device_ms": device_ms(torch, lib), "gflop": ops / 1e9,
          "device_tflops": ops / (dev_ms * 1e-3) / 1e12, "share_of_bound": bound_ms / dev_ms,
          "mma_sync_design": K4_BWD_MMA_SYNC_MS,
          "workspace_bytes": plan.workspace_bytes,
          "plan": {"kv_items": plan.kv_items, "q_items": plan.q_items,
                   "kv_grid": plan.kv_grid, "q_grid": plan.q_grid,
                   "kv_smem": plan.kv_smem, "q_smem": plan.q_smem,
                   "kv_queries_a_step": plan.kv_queries, "q_keys_a_step": plan.q_keys},
          "training_shape_launches_bitwise": 3,
          "forward_bits_kept_with_lse": True, "vmap_cohort_bitwise": True,
          "tolerance_rel_to_max": BWD_TOL, "lse_tolerance": LSE_TOL,
          "lse_max_abs_err": max(e["lse_abs"] for e in errs.values()),
          "rel_err_by_case": errs})
    return entry


def _token_batches(torch, vocab, steps, B, S, seed=0):
    """``steps`` (tokens, labels) batches of one ``make_token_stream``, moved
    to the card once (a step slices views)."""
    from repro_torch.data.synthetic import make_token_stream

    stream = make_token_stream(vocab, steps * B * (S + 1), seed)
    docs = torch.as_tensor(stream, device="cuda").view(steps, B, S + 1)
    return [{"tokens": docs[i, :, :-1], "labels": docs[i, :, 1:]} for i in range(steps)]


def phase_lm_train(torch, k4):
    """tinyllama-1.1b at full width and depth (22 layers, bf16, weights from
    seed 0) trained by ``model.sgd_train_step`` at (B, S) = TRAIN_SHAPE with
    ``build``'s default remat: K4 forward 2 x 22 and backward 22 launches a
    step, no plain or kernel-off attention, finite loss and params that
    moved, no host sync in a step; ms a step, tokens/s, the share of the
    bf16 peak, device-busy share, K4's share of device time and each of its
    backward kernels' device time a launch, peak memory with remat on and
    off."""
    from repro_torch.configs import get_arch
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import factory

    cfg = get_arch(LM_ARCH)
    model = factory.build(cfg)
    L = cfg.num_layers
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(t.numel() for t in tree_leaves(params))
    B, S = TRAIN_SHAPE
    batches = _token_batches(torch, cfg.vocab_size, LM_TRAIN_STEPS + 4, B, S)
    lr = torch.full((), LM_TRAIN_LR, device="cuda")
    plain_calls = {}
    restore = [_count_calls(k4, ["flash_attention_plain", "flash_attention_bwd_plain"],
                            plain_calls),
               _count_calls(attn_mod, ["_attend_direct", "_attend_flash_jnp"], plain_calls)]
    first = [t.clone() for t in tree_leaves(params)[:3]]
    try:
        per_step, losses = [], []
        k4.launches = k4.bwd_launches = 0  # the path's counts: its LM_TRAIN_STEPS steps
        for i in range(LM_TRAIN_STEPS):
            f0, b0 = k4.launches, k4.bwd_launches
            t0 = time.perf_counter()
            params, metrics = model.sgd_train_step(params, batches[i], lr)
            torch.cuda.synchronize()
            per_step.append((time.perf_counter() - t0) * 1e3)
            launched = (k4.launches - f0, k4.bwd_launches - b0)
            if launched != (2 * L, L):
                raise AssertionError(f"lm_train: K4 forward/backward launched {launched} "
                                     f"times in a step of {L} layers (want {(2 * L, L)})")
            losses.append(float(metrics["loss"]))
        counts = (k4.launches, k4.bwd_launches)
        if plain_calls:
            raise AssertionError(f"lm_train: plain or kernel-off attention ran: {plain_calls}")
        state = {"p": params}

        def step(i=LM_TRAIN_STEPS):
            state["p"], state["m"] = model.sgd_train_step(state["p"], batches[i], lr)

        syncs = _syncs_in(torch, step)
        if syncs:
            raise AssertionError(f"lm_train: a step synchronized: {syncs[:3]}")
        union, window, by_name, _ = _profile(torch, lambda: step(LM_TRAIN_STEPS + 1), 2)
        params = state["p"]
    finally:
        for fn in restore:
            fn()
    leaves = tree_leaves(params)
    if not (all(map(math.isfinite, losses)) and all(bool(torch.isfinite(t).all())
                                                   for t in leaves)):
        raise AssertionError(f"lm_train: non-finite loss {losses} or params")
    if all(torch.equal(a, b) for a, b in zip(first, leaves[:3])):
        raise AssertionError("lm_train: the params did not move")
    peaks = {}
    for remat in (True, False):
        m = factory.build(cfg, remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out, _ = m.sgd_train_step(params, batches[LM_TRAIN_STEPS + 2], lr)
        torch.cuda.synchronize()
        peaks["remat" if remat else "no_remat"] = {
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "above_params_gib": (torch.cuda.max_memory_allocated() - base) / 2**30}
        del out
    bwd_share = sum(_share(by_name, n) for n in K4_BWD_KERNELS)
    if not bwd_share > 0:
        raise AssertionError(f"lm_train: no device time under K4's backward kernels "
                             f"{K4_BWD_KERNELS}")
    ms = statistics.median(per_step[1:])  # step 0 warms up cuBLAS and the kernels
    tokens = B * S
    a = cfg.pattern[0].attn
    pairs = S * (S + 1) // 2
    attn_flops = 14 * B * a.num_heads * a.head_dim * pairs * L  # forward 4 D, backward 10 D
    flops = 6 * n_params * tokens + attn_flops
    emit({"phase": "lm_train", "ok": True, "arch": cfg.name, "layers": L,
          "params": n_params, "batch": B, "seq": S, "steps": LM_TRAIN_STEPS, "lr": LM_TRAIN_LR,
          "remat": True, "k4_launches_per_step": 2 * L, "k4_bwd_launches_per_step": L,
          "plain_calls": 0, "host_syncs_in_a_step": 0, "losses": losses,
          "ms_per_step": ms, "ms_per_step_all": per_step, "first_step_ms": per_step[0], "tokens_per_s": tokens / ms * 1e3,
          "model_tflops": flops / (ms * 1e-3) / 1e12,
          "share_of_bf16_peak": flops / (ms * 1e-3) / BF16_OPS_PER_S,
          "flops_counted": "6 N tokens + 14 D per head per causal pair per layer "
                           "(remat's recompute not counted)",
          "profile_2_steps": {
              "device_union_ms_per_step": union / 2, "window_ms_per_step": window / 2,
              "device_busy_share": union / window,
              "k4_share_of_device_time": _share(by_name, "attn_wgmma_kernel"),
              "k4_bwd_share_of_device_time": bwd_share,
              "k4_bwd_ms_per_step": {n: sum(v for key, v in by_name.items() if n in key) / 2
                                     for n in K4_BWD_KERNELS},
              # each backward kernel's device time a launch at the training
              # shape: a profile of five backward calls inside kernel_k4_bwd,
              # late in the script, kept no kernel record (with acc_events,
              # and held 0.5 s longer on each side); this one keeps all
              "k4_bwd_device_ms_a_launch": {
                  n: sum(v for key, v in by_name.items() if n in key) / (2 * L)
                  for n in K4_BWD_KERNELS},
              "top": sorted(((round(v / 2, 4), n[:80]) for n, v in by_name.items()),
                            reverse=True)[:8]},
          "peak_memory": peaks,
          "logits_note": "lm_loss keeps the full (4, 2048, 32000) f32 logits (1.05 GB): "
                         "_vocab_chunk returns 0 at S = 2048"})
    return counts


def phase_lm_grad_parity(torch, k4):
    """The reduced tinyllama in f32 with TF32 off, from the same numpy
    weights on the card and on the CPU: ``model.loss`` gradients at S = 128
    and 256 (K4 forward and backward on the card, the plain route on the
    CPU) within 1e-4 of each leaf's max, then one ``sgd_train_step``: the
    params allclose."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.models import factory

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(LM_ARCH).reduced()
    model = factory.build(cfg)
    weights = model.init(torch.Generator().manual_seed(0))  # on the CPU, then copied
    rng = np.random.default_rng(0)
    worst, f0, b0 = {}, k4.launches, k4.bwd_launches
    for S in (128, 256):
        toks = rng.integers(0, cfg.vocab_size, (2, S + 1)).astype(np.int32)
        grads = {}
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda t: t.detach().to(dev).requires_grad_(), weights)
            t = torch.from_numpy(toks).to(dev)
            loss, _ = model.loss(p, {"tokens": t[:, :-1], "labels": t[:, 1:]})
            grads[dev] = [g.cpu() for g in torch.autograd.grad(loss, tree_leaves(p))]
        worst[S] = max(_rel_err(a, b) for a, b in zip(grads["cuda"], grads["cpu"]))
        if worst[S] > 1e-4:
            raise AssertionError(f"lm_grad_parity: S={S} gradients off the CPU's by "
                                 f"{worst[S]} of a leaf's max")
    launched = (k4.launches - f0, k4.bwd_launches - b0)
    # remat: the forward twice a layer; two sequence lengths
    if launched != (2 * 2 * cfg.num_layers, 2 * cfg.num_layers):
        raise AssertionError(f"lm_grad_parity: K4 launched {launched} times on the card")
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 129)).astype(np.int32))
    new = {}
    for dev in ("cpu", "cuda"):
        t = toks.to(dev)
        new[dev], _ = model.sgd_train_step(tree_map(lambda w: w.to(dev), weights),
                                           {"tokens": t[:, :-1], "labels": t[:, 1:]}, 3e-3)
    step_gap = max(float((a.cpu() - b).abs().max())
                   for a, b in zip(tree_leaves(new["cuda"]), tree_leaves(new["cpu"])))
    if not all(torch.allclose(a.cpu(), b, rtol=1e-5, atol=1e-6)
               for a, b in zip(tree_leaves(new["cuda"]), tree_leaves(new["cpu"]))):
        raise AssertionError(f"lm_grad_parity: one SGD step off the CPU's by {step_gap}")
    emit({"phase": "lm_grad_parity", "ok": True, "arch": cfg.name, "batch": 2,
          "k4_launches": launched, "grad_rel_err_by_seq": worst, "grad_tol": 1e-4,
          "sgd_step_max_abs_gap": step_gap, "sgd_step_tol": {"rtol": 1e-5, "atol": 1e-6},
          "tf32": False})
    return launched


def phase_train_main(torch, k4):
    """The driver's own path, ``repro_torch.launch.train`` at the
    reference's defaults (tinyllama widened to ~20M params, batch 8, seq
    128, lr 3e-3, 200 steps): K4 forward and backward every step, the final
    loss below the initial one; tok/s and peak memory."""
    import numpy as np

    from repro_torch.launch import train

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    f0, b0 = k4.launches, k4.bwd_launches
    res = train.main(TRAIN_ARGV)
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = len(res["losses"])
    layers = res["cfg"].num_layers
    launched = (k4.launches - f0, k4.bwd_launches - b0)
    if launched != (2 * layers * steps, layers * steps):
        raise AssertionError(f"train_main: K4 launched {launched} times in {steps} steps")
    first, last = float(np.mean(res["losses"][:10])), float(np.mean(res["losses"][-10:]))
    if not (math.isfinite(last) and last < first):
        raise AssertionError(f"train_main: loss did not fall ({first} -> {last})")
    emit({"phase": "train_main", "ok": True, "argv": TRAIN_ARGV, "arch": res["cfg"].name,
          "d_model": res["cfg"].d_model, "layers": layers, "steps": steps,
          "k4_launches": launched[0], "k4_bwd_launches": launched[1],
          "initial_loss": first, "final_loss": last, "tokens_per_s": res["tokens_per_s"],
          "seconds": res["seconds"], "peak_mem_gib": peak})
    return launched


def phase_fl_lm(torch, event_topk, fedavg_reduce):
    """The LM as the federated workload: ``fl_train --arch tinyllama-1.1b``
    at the paper's sync settings (10 rounds; K1 once a round over the
    reduced LM's 21 leaves: one ``fedavg_reduce_leaves`` call, two grouped
    launches of <= 16 leaves) and ``fl_async --arch`` at 16 384 clients and
    k = 256 (5 steps, K2 once a step); finite losses, peak memory."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch import fl_async, fl_train

    out = {"phase": "fl_lm", "ok": True}
    for name, driver, argv in (("sync", fl_train, FL_LM_SYNC_ARGV),
                               ("async", fl_async, FL_LM_ASYNC_ARGV)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fedavg_reduce.launches = event_topk.launches = 0
        t0 = time.time()
        res = driver.main(argv)
        wall = time.time() - t0
        cfg = res.config
        leaves = len(tree_leaves(res.params))
        evals = [r.eval_loss for r in res.records]
        trains = [r.train_loss for r in res.records if name == "sync" or r.buffer_fill > 0]
        if not evals or not all(map(math.isfinite, evals + trains)):
            raise AssertionError(f"fl_lm {name}: non-finite losses {evals} {trains}")
        if name == "sync":
            per_call = -(-leaves // fedavg_reduce.MAX_LEAVES)
            if fedavg_reduce.launches != cfg.rounds * per_call:
                raise AssertionError(f"fl_lm sync: K1 launched {fedavg_reduce.launches} "
                                     f"times in {cfg.rounds} rounds of {leaves} leaves")
        elif event_topk.launches != cfg.rounds:
            raise AssertionError(f"fl_lm async: K2 launched {event_topk.launches} times "
                                 f"in {cfg.rounds} steps")
        out[name] = {"argv": argv, "rounds": cfg.rounds, "param_leaves": leaves,
                     "k1_launches": fedavg_reduce.launches, "k2_launches": event_topk.launches,
                     "eval_loss": evals[-1],
                     "first_eval_loss": evals[0], "wall_s": wall,
                     "steps_per_s": cfg.rounds / res.wall_time_s,
                     "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    emit(out)
    return out["sync"]["k1_launches"], out["async"]["k2_launches"]


# ---------------------------------------------------------------------------
# slice G2b: Mamba2 training (K6's backward, sgd_train_step, the train driver
# and both FL drivers on mamba2)
# ---------------------------------------------------------------------------

SSM_TRAIN_STEPS = 5
SSM_TRAIN_LR = 3e-3
# the K6 backward against the plain backward, of each gradient's max: f32
# inputs; f32 outputs (ddt, dA, dh0) of bf16 inputs; outputs written in bf16
# (dx, dB, dC: one bf16 rounding, 2^-8 of the value at most, and the f32
# outputs' share), as tests/test_torch_ssd_scan_bwd.py settles them on the CPU
K6_BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-3, "bf16_out": 2.0 ** -8 + 1e-3}
K6_BWD_GRADS = ("dx", "ddt", "dA", "dB", "dC", "dh0")
# the backward's kernels by name (the bf16 tensor-core route: the pre-pass,
# the reverse pass, the j-side and i-side wgmma kernels, the tail and the
# sums; the FMA route: dstate, pass, chunk and sums; no name is a substring
# of another). Its CB pass is the forward's ssd_cb_kernel, counted with K6's
# forward.
K6_BWD_KERNELS = ("ssd_bwd_prep_kernel", "ssd_bwd_pass_kernel", "ssd_bwd_jside_kernel",
                  "ssd_bwd_iside_kernel", "ssd_bwd_tail_kernel", "ssd_bwd_sum_kernel",
                  "ssd_bwd_dstate_kernel", "ssd_bwd_chunk_kernel")
# the mma.sync design this route replaced, at the training shape (PERF.md
# §6's K6 bwd row, H100 80GB HBM3 at 700.00 W)
K6_BWD_MMA_SYNC_MS = {"ms": 1.116, "device_ms": 1.104}
SSM_TRAIN_ARGV = [SSM_ARCH if a == LM_ARCH else a for a in TRAIN_ARGV]
FL_SSM_SYNC_ARGV = [SSM_ARCH if a == LM_ARCH else a for a in FL_LM_SYNC_ARGV]
FL_SSM_ASYNC_ARGV = [SSM_ARCH if a == LM_ARCH else a for a in FL_LM_ASYNC_ARGV]


def _k6_bwd_tol(name, dt) -> float:
    if str(dt) == "torch.bfloat16" and name in ("dx", "dB", "dC"):
        return K6_BWD_TOL["bf16_out"]
    return K6_BWD_TOL[str(dt)[6:]]


def phase_kernel_k6_bwd(torch, k6):
    """K6's backward (``csrc/ssd_scan_bwd.cu``) against
    ``ssd_chunked_bwd_plain`` on the card, TF32 off: mamba2-370m's training
    shape (4, 2048, 32, 64, 128), chunk 256, bf16 strided slices of the
    conv output; f32 and bf16 at (hd, ds) = (32, 16), (64, 64), (64, 128),
    chunks 16, 64, 100 (S = 200) and 256, each with h0 and dh_final absent
    and present; and a case whose sum dt |A| over a chunk passes exp's f32
    range. The plain side gets only what it computes itself: its h_in from
    the plain forward; the kernel forward's h_in is held to it at K6_TOL,
    its y bitwise to the forward without h_in (and with A one row per
    batch row at the training shape). Gradients within K6_BWD_TOL of each
    gradient's max, finite, two launches bitwise equal (three at the
    training shape); the time beside its bound, the FMA schedule's, the
    mma.sync design's and the plain backward's; the plan's grids and head
    groups and the workspace's bytes."""
    gen = torch.Generator(device="cuda").manual_seed(24)
    bf16, f32 = torch.bfloat16, torch.float32
    B, S = TRAIN_SHAPE
    main = (B, S, 32, 64, 128)  # mamba2-370m: 32 heads of 64, d_state 128
    cases = [(main, 256, bf16, True, False)]
    cases += [((2, 200 if L == 100 else 2 * max(L, 32), 4, hd, ds), L, dt_, dt_ is bf16, False)
              for dt_ in (f32, bf16) for hd, ds in ((32, 16), (64, 64), (64, 128))
              for L in (16, 64, 100, 256)]
    # sum dt |A| over a chunk: 256 * 0.05 * 16 = 205, past exp's f32 range
    cases += [((1, 512, 4, 64, 64), 256, f32, True, True)]
    errs = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's einsums in f32
    try:
        for shape, L, dt_, strided, overflow in cases:
            x, dt, A, B_, C_ = _ssd_inputs(torch, gen, shape, dt_, strided)
            if overflow:
                dt, A = torch.full_like(dt, 0.05), torch.full_like(A, -16.0)
            Bx, _, nh, hd, ds = shape
            dy = torch.randn(x.shape, generator=gen, device="cuda")
            h0, dhf = (torch.randn((Bx, nh, hd, ds), generator=gen, device="cuda")
                       for _ in range(2))
            for init, dh in ((None, None), (h0, dhf)):
                name = (f"{shape}_L{L}_{str(dt_)[6:]}{'_h0_dhf' if dh is not None else ''}"
                        f"{'_overflow' if overflow else ''}")
                y, _, h_in = k6.ssd_scan_with_h_in(x, dt, A, B_, C_, L, init)
                if not torch.equal(y, k6.ssd_scan(x, dt, A, B_, C_, L, init)[0]):
                    raise AssertionError(f"K6 {name}: y's bits move with h_in")
                _, _, h_plain = k6.ssd_chunked_plain(x, dt, A, B_, C_, L, init,
                                                     return_h_in=True)
                if not torch.allclose(h_in, h_plain, atol=K6_TOL, rtol=K6_TOL):
                    raise AssertionError(f"K6 {name}: h_in off the plain forward's by "
                                         f"{float((h_in - h_plain).abs().max())}")
                grads = k6.ssd_scan_bwd(x, dt, A, B_, C_, L, h_plain, dy, dh)
                again = k6.ssd_scan_bwd(x, dt, A, B_, C_, L, h_plain, dy, dh)
                plain = k6.ssd_chunked_bwd_plain(x, dt, A.expand(Bx, nh), B_, C_, L, h_plain,
                                                 dy, dh)
                torch.cuda.synchronize()
                errs[name] = {"h_in_abs": float((h_in - h_plain).abs().max())}
                for g_name, g, a, p in zip(K6_BWD_GRADS, grads, again, plain):
                    if not torch.equal(g, a):
                        raise AssertionError(f"K6 bwd {name}: {g_name} launches differ bitwise")
                    if not (bool(torch.isfinite(g).all()) and bool(torch.isfinite(p).all())):
                        raise AssertionError(f"K6 bwd {name}: {g_name} not finite")
                    errs[name][g_name] = _rel_err(g, p)
                    if errs[name][g_name] > _k6_bwd_tol(g_name, dt_):
                        raise AssertionError(
                            f"K6 bwd {name}: {g_name} off its plain version by "
                            f"{errs[name][g_name]} of its max (tol {_k6_bwd_tol(g_name, dt_)})")
                del plain, grads, again

        # timing at the training shape, in the model's layout
        x, dt, A, B_, C_ = _ssd_inputs(torch, gen, main, bf16)
        Bm, Sm, nh, hd, ds = main
        rows = A.expand(Bm, nh).contiguous()  # A as one row per batch row: the same bits
        if not torch.equal(k6.ssd_scan(x, dt, A, B_, C_, 256)[0],
                           k6.ssd_scan(x, dt, rows, B_, C_, 256)[0]):
            raise AssertionError("K6: y's bits move with A given one row per batch row")
        dy = torch.randn(x.shape, generator=gen, device="cuda")
        _, _, h_in = k6.ssd_scan_with_h_in(x, dt, A, B_, C_, 256)
        run = lambda: k6.ssd_scan_bwd(x, dt, A, B_, C_, 256, h_in, dy)  # noqa: E731
        plain = lambda: k6.ssd_chunked_bwd_plain(x, dt, A.expand(Bm, nh), B_, C_,  # noqa: E731
                                                 256, h_in, dy)
        L, nc = 256, Sm // 256
        ops, *rw = k6.cost(Bm, Sm, nh, hd, ds, L, bf16, backward=True)
        nbytes = sum(rw)
        nb = L // 64
        pairs, blk = nb * (nb + 1) // 2, 64 * 64 * 2  # causal block pairs; 2 x 64 x 64
        # the FMA route's schedule: f32 FMA on whole 64 x 64 blocks, CB per head
        fma_ops = k6.cost(Bm, Sm, nh, hd, ds, L, f32, backward=True)[0]
        # the tensor-core route's wgmma work: per (b, head, chunk) the pre-pass's
        # state term (2 terms), the j side's leaving-state terms (2 products of
        # 2 terms a block) and its block pairs (dM^T 2, dx 3, dB 2 products),
        # the i side's entering-state term (3 products a block) and block pairs
        # (dM 2, dC 2); CB once per (b, chunk)
        wgmma_ops = Bm * nh * nc * (2 * 2 * L * hd * ds + nb * 4 * 2 * 64 * hd * ds
                                    + pairs * blk * (5 * hd + 2 * ds)
                                    + nb * 3 * 2 * 64 * hd * ds + pairs * blk * (2 * hd + 2 * ds)) \
            + Bm * nc * pairs * blk * ds
        n_state = Bm * nh * nc * hd * ds
        plan = k6.bwd_plan(Bm, Sm, nh, hd, ds, L,
                           sms=torch.cuda.get_device_properties(0).multi_processor_count)
        # the workspace's traffic, each region written once and read once by
        # each kernel that reads it: the chunks' own terms (pre-pass, pass);
        # dy's planes (pre-pass; j side, i side); dH_out's and h_in's planes
        # (pass; j side, i side); CB (written; j side, i side); the head
        # groups' dB and dC (j side, i side; sums); the row vectors are < 1%
        ws_bytes = (2 * n_state * 4 + 3 * x.numel() * 4 + 2 * 2 * n_state * 4
                    + 3 * Bm * nc * pairs * 64 * 64 * 4 + 2 * 2 * plan.groups * Bm * Sm * ds * 4)
        k6.bwd_launches = 0
        bound_s = max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S)
        first = run()
        again, third = run(), run()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(first, again, third)):
            raise AssertionError("K6 bwd: three launches at the training shape differ bitwise")
        del again, third
        entry = {
            "name": "ssd_scan_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_scan_bwd.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:75",
            "max_abs_err": max(float((g.float() - p.float()).abs().max())
                               for g, p in zip(first, plain())),
            "ms": cuda_ms(torch, run, calls=10, trials=5),
            "plain_ms": cuda_ms(torch, plain, calls=2, trials=3, warmup=1),
            "bound_ms": bound_s * 1e3,
            "bound_by": "operations" if ops / BF16_OPS_PER_S > nbytes / HBM_BYTES_PER_S
            else "bytes",
            "library_ms": None,  # no single PyTorch call computes the scan's backward
        }
        dev_ms = device_ms(torch, run)
        k6.bwd_launches = 0
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    emit({"phase": "kernel_k6_bwd", "ok": True, "cases": len(errs), "shape": list(main),
          "chunk": 256, "dtype": "bfloat16", "inputs": "strided slices of (B, S, 2304)",
          "tolerance_rel_to_max": K6_BWD_TOL, "h_in_tolerance": K6_TOL,
          "bf16_terms": k6.BWD_TERMS, **entry,
          "device_ms": dev_ms, "gflop": ops / 1e9, "fma_gflop": fma_ops / 1e9,
          "wgmma_gflop": wgmma_ops / 1e9, "device_wgmma_tflops": wgmma_ops / (dev_ms * 1e-3) / 1e12,
          "mma_sync_design": {**K6_BWD_MMA_SYNC_MS, "source": "PERF.md §6, the K6 bwd row"},
          "plan": {"group": plan.group, "groups": plan.groups, "items": plan.items,
                   "j_grid": plan.j_grid, "i_grid": plan.i_grid, "j_smem": plan.j_smem,
                   "i_smem": plan.i_smem, "launches": plan.launches,
                   "workspace_mbytes": plan.workspace_bytes / 1e6},
          "mbytes": nbytes / 1e6, "workspace_traffic_mbytes": ws_bytes / 1e6,
          "fma_bound_ms": max(nbytes / HBM_BYTES_PER_S, fma_ops / FP32_OPS_PER_S) * 1e3,
          "workspace_bound_ms": max((nbytes + ws_bytes) / HBM_BYTES_PER_S,
                                    ops / BF16_OPS_PER_S) * 1e3,
          "device_fma_tflops": fma_ops / (dev_ms * 1e-3) / 1e12,
          "share_of_bound": bound_s * 1e3 / dev_ms, "launches_bitwise": 2,
          "launches_bitwise_at_training_shape": 3,
          "forward_bits_kept_with_h_in": True, "forward_bits_kept_with_a_rows": True,
          "rel_err_by_case": errs})
    return entry


def phase_ssm_train(torch, k6):
    """mamba2-370m at full width and depth (48 layers, bf16, weights from
    seed 0) trained by ``model.sgd_train_step`` at (B, S) = TRAIN_SHAPE,
    lr 3e-3, 5 steps, remat on: K6 forward 2 x 48 and backward 48 launches
    a step, no plain scan (``ssd_chunked_plain``, ``ssd_chunked_bwd_plain``,
    ``ssd_reference``), finite losses and params that moved, no host sync in
    a step; ms a step, tokens/s, the share of the bf16 peak, device-busy
    share, K6's backward's share of device time and each of its kernels'
    device time a launch, peak memory with remat on and off."""
    from repro_torch.configs import get_arch
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models import factory
    from repro_torch.models import ssm as ssm_mod

    cfg = get_arch(SSM_ARCH)
    model = factory.build(cfg)
    L = cfg.num_layers
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(t.numel() for t in tree_leaves(params))
    B, S = TRAIN_SHAPE
    batches = _token_batches(torch, cfg.vocab_size, SSM_TRAIN_STEPS + 4, B, S)
    lr = torch.full((), SSM_TRAIN_LR, device="cuda")
    plain_calls = {}
    restore = [_count_calls(k6, ["ssd_chunked_plain", "ssd_chunked_bwd_plain"], plain_calls),
               _count_calls(ssm_mod, ["ssd_reference"], plain_calls)]
    first = [t.clone() for t in tree_leaves(params)[:4]]
    try:
        per_step, losses = [], []
        k6.launches = k6.bwd_launches = 0  # the path's counts: its SSM_TRAIN_STEPS steps
        for i in range(SSM_TRAIN_STEPS):
            f0, b0 = k6.launches, k6.bwd_launches
            t0 = time.perf_counter()
            params, metrics = model.sgd_train_step(params, batches[i], lr)
            torch.cuda.synchronize()
            per_step.append((time.perf_counter() - t0) * 1e3)
            launched = (k6.launches - f0, k6.bwd_launches - b0)
            if launched != (2 * L, L):
                raise AssertionError(f"ssm_train: K6 forward/backward launched {launched} "
                                     f"times in a step of {L} layers (want {(2 * L, L)})")
            losses.append(float(metrics["loss"]))
        counts = (k6.launches, k6.bwd_launches)
        if plain_calls:
            raise AssertionError(f"ssm_train: a plain scan ran: {plain_calls}")
        state = {"p": params}

        def step(i=SSM_TRAIN_STEPS):
            state["p"], state["m"] = model.sgd_train_step(state["p"], batches[i], lr)

        syncs = _syncs_in(torch, step)
        if syncs:
            raise AssertionError(f"ssm_train: a step synchronized: {syncs[:3]}")
        union, window, by_name, records = _profile(torch, lambda: step(SSM_TRAIN_STEPS + 1),
                                                   2)
        params = state["p"]
    finally:
        for fn in restore:
            fn()
    leaves = tree_leaves(params)
    if not (all(map(math.isfinite, losses)) and all(bool(torch.isfinite(t).all())
                                                   for t in leaves)):
        raise AssertionError(f"ssm_train: non-finite loss {losses} or params")
    if all(torch.equal(a, b) for a, b in zip(first, leaves[:4])):
        raise AssertionError("ssm_train: the params did not move")
    peaks = {}
    for remat in (True, False):
        m = factory.build(cfg, remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out, _ = m.sgd_train_step(params, batches[SSM_TRAIN_STEPS + 2], lr)
        torch.cuda.synchronize()
        peaks["remat" if remat else "no_remat"] = {
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "above_params_gib": (torch.cuda.max_memory_allocated() - base) / 2**30}
        del out
    k6.launches = k6.bwd_launches = 0
    # the launch counts above prove the kernels ran; a profile that kept no
    # kernel record (PERF.md §7) is reported as such, its shares as 0
    bwd_share = sum(_share(by_name, n) for n in K6_BWD_KERNELS)
    ms = statistics.median(per_step[1:])  # step 0 warms up cuBLAS and the kernels
    tokens = B * S
    kinds = {"gemm": ("gemm", "nvjet", "xmma", "cutlass"), "k6_backward": ("ssd_bwd",),
             "k6_forward": ("ssd_",), "elementwise": ("elementwise", "copy")}
    by_kind = dict.fromkeys(list(kinds) + ["other"], 0.0)
    for name, v in by_name.items():  # each kernel under the first kind it matches
        kind = next((k for k, keys in kinds.items() if any(n in name for n in keys)), "other")
        by_kind[kind] += v / 2
    s = cfg.pattern[0].ssm
    # the flops the chunked scan needs: the causal pairs' products (CB once
    # per (batch, chunk)) and each (batch, head, chunk)'s state products;
    # the backward's are K6 bwd's tensor-core count
    nc, pairs = S // s.chunk, s.chunk * (s.chunk + 1) // 2
    scan_fwd = B * nc * pairs * 2 * s.d_state + B * s.num_heads * nc * (
        pairs * 2 * s.head_dim + 4 * s.chunk * s.head_dim * s.d_state)
    scan_bwd = k6.cost(B, S, s.num_heads, s.head_dim, s.d_state, s.chunk, torch.bfloat16,
                       backward=True)[0]
    flops = 6 * n_params * tokens + (scan_fwd + scan_bwd) * L
    emit({"phase": "ssm_train", "ok": True, "arch": cfg.name, "layers": L,
          "params": n_params, "batch": B, "seq": S, "steps": SSM_TRAIN_STEPS,
          "lr": SSM_TRAIN_LR, "remat": True, "k6_launches_per_step": 2 * L,
          "k6_bwd_launches_per_step": L, "plain_calls": 0, "host_syncs_in_a_step": 0,
          "losses": losses, "ms_per_step": ms, "ms_per_step_all": per_step,
          "first_step_ms": per_step[0], "tokens_per_s": tokens / ms * 1e3,
          "model_tflops": flops / (ms * 1e-3) / 1e12,
          "share_of_bf16_peak": flops / (ms * 1e-3) / BF16_OPS_PER_S,
          "flops_counted": "6 N tokens + the scan's forward and backward per layer "
                           "(causal pairs and state products; remat's recompute not "
                           "counted)",
          "profile_2_steps": {
              "kernel_records": records,
              "device_union_ms_per_step": union / 2, "window_ms_per_step": window / 2,
              "device_busy_share": union / window,
              "k6_share_of_device_time": _share(by_name, "ssd_") - bwd_share,
              "k6_bwd_share_of_device_time": bwd_share,
              "device_ms_per_step_by_kind": by_kind,
              "k6_bwd_ms_per_step": {n: sum(v for key, v in by_name.items() if n in key) / 2
                                     for n in K6_BWD_KERNELS},
              "k6_bwd_device_ms_a_launch": {
                  n: sum(v for key, v in by_name.items() if n in key) / (2 * L)
                  for n in K6_BWD_KERNELS},
              "top": sorted(((round(v / 2, 4), n[:80]) for n, v in by_name.items()),
                            reverse=True)[:10]},
          "peak_memory": peaks,
          "logits_note": "lm_loss keeps the full (4, 2048, 50280) f32 logits (1.65 GB): "
                         "_vocab_chunk returns 0 at S = 2048"})
    return counts


def phase_ssm_grad_parity(torch, k6):
    """The reduced mamba2 in f32 with TF32 off, from the same weights on the
    card and on the CPU: ``model.loss`` gradients at S = 64 and 128 (K6
    forward and backward on the card, the plain route on the CPU) within
    1e-4 of each leaf's max, then one ``sgd_train_step``: the params
    allclose (rtol 1e-5, atol 1e-6)."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.models import factory

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(SSM_ARCH).reduced()
    model = factory.build(cfg)
    weights = model.init(torch.Generator().manual_seed(0))  # on the CPU, then copied
    rng = np.random.default_rng(0)
    worst, f0, b0 = {}, k6.launches, k6.bwd_launches
    for S in (64, 128):
        toks = rng.integers(0, cfg.vocab_size, (2, S + 1)).astype(np.int32)
        grads = {}
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda t: t.detach().to(dev).requires_grad_(), weights)
            t = torch.from_numpy(toks).to(dev)
            loss, _ = model.loss(p, {"tokens": t[:, :-1], "labels": t[:, 1:]})
            grads[dev] = [g.cpu() for g in torch.autograd.grad(loss, tree_leaves(p))]
        worst[S] = max(_rel_err(a, b) for a, b in zip(grads["cuda"], grads["cpu"]))
        if worst[S] > 1e-4:
            raise AssertionError(f"ssm_grad_parity: S={S} gradients off the CPU's by "
                                 f"{worst[S]} of a leaf's max")
    launched = (k6.launches - f0, k6.bwd_launches - b0)
    # remat: the forward twice a layer; two sequence lengths
    if launched != (2 * 2 * cfg.num_layers, 2 * cfg.num_layers):
        raise AssertionError(f"ssm_grad_parity: K6 launched {launched} times on the card")
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 129)).astype(np.int32))
    new = {}
    for dev in ("cpu", "cuda"):
        t = toks.to(dev)
        new[dev], _ = model.sgd_train_step(tree_map(lambda w: w.to(dev), weights),
                                           {"tokens": t[:, :-1], "labels": t[:, 1:]}, 3e-3)
    step_gap = max(float((a.cpu() - b).abs().max())
                   for a, b in zip(tree_leaves(new["cuda"]), tree_leaves(new["cpu"])))
    if not all(torch.allclose(a.cpu(), b, rtol=1e-5, atol=1e-6)
               for a, b in zip(tree_leaves(new["cuda"]), tree_leaves(new["cpu"]))):
        raise AssertionError(f"ssm_grad_parity: one SGD step off the CPU's by {step_gap}")
    emit({"phase": "ssm_grad_parity", "ok": True, "arch": cfg.name, "batch": 2,
          "k6_launches": launched, "grad_rel_err_by_seq": worst, "grad_tol": 1e-4,
          "sgd_step_max_abs_gap": step_gap, "sgd_step_tol": {"rtol": 1e-5, "atol": 1e-6},
          "tf32": False})


def phase_fl_ssm(torch, event_topk, fedavg_reduce, k6):
    """mamba2 as the federated workload and the train driver's own path:
    ``fl_train --arch mamba2-370m`` at the paper's sync settings (10
    rounds, K1 once a round) and ``fl_async --arch mamba2-370m`` at 16 384
    clients and k = 256 (5 steps, K2 once a step), the clients' ``vmap(grad)``
    through K6's forward and backward; finite losses. Then
    ``launch/train.py --arch mamba2-370m`` at TRAIN_ARGV's settings: K6
    forward twice and backward once a layer a step, the loss falls."""
    import numpy as np

    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch import fl_async, fl_train, train

    out = {"phase": "fl_ssm", "ok": True}
    for name, driver, argv in (("sync", fl_train, FL_SSM_SYNC_ARGV),
                               ("async", fl_async, FL_SSM_ASYNC_ARGV)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fedavg_reduce.launches = event_topk.launches = k6.launches = k6.bwd_launches = 0
        t0 = time.time()
        res = driver.main(argv)
        wall = time.time() - t0
        cfg = res.config
        leaves = len(tree_leaves(res.params))
        evals = [r.eval_loss for r in res.records]
        trains = [r.train_loss for r in res.records if name == "sync" or r.buffer_fill > 0]
        if not evals or not all(map(math.isfinite, evals + trains)):
            raise AssertionError(f"fl_ssm {name}: non-finite losses {evals} {trains}")
        if not (k6.launches > 0 and k6.bwd_launches > 0):
            raise AssertionError(f"fl_ssm {name}: K6 launched {k6.launches} forward and "
                                 f"{k6.bwd_launches} backward times")
        if name == "sync":
            per_call = -(-leaves // fedavg_reduce.MAX_LEAVES)
            if fedavg_reduce.launches != cfg.rounds * per_call:
                raise AssertionError(f"fl_ssm sync: K1 launched {fedavg_reduce.launches} "
                                     f"times in {cfg.rounds} rounds of {leaves} leaves")
        elif event_topk.launches != cfg.rounds:
            raise AssertionError(f"fl_ssm async: K2 launched {event_topk.launches} times "
                                 f"in {cfg.rounds} steps")
        out[name] = {"argv": argv, "rounds": cfg.rounds, "param_leaves": leaves,
                     "k1_launches": fedavg_reduce.launches, "k2_launches": event_topk.launches,
                     "k6_launches": k6.launches, "k6_bwd_launches": k6.bwd_launches,
                     "eval_loss": evals[-1], "first_eval_loss": evals[0], "wall_s": wall,
                     "steps_per_s": cfg.rounds / res.wall_time_s,
                     "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k6.launches = k6.bwd_launches = 0
    res = train.main(SSM_TRAIN_ARGV)
    steps, layers = len(res["losses"]), res["cfg"].num_layers
    launched = (k6.launches, k6.bwd_launches)
    if launched != (2 * layers * steps, layers * steps):
        raise AssertionError(f"fl_ssm train: K6 launched {launched} times in {steps} steps")
    first, last = float(np.mean(res["losses"][:10])), float(np.mean(res["losses"][-10:]))
    if not (math.isfinite(last) and last < first):
        raise AssertionError(f"fl_ssm train: loss did not fall ({first} -> {last})")
    out["train"] = {"argv": SSM_TRAIN_ARGV, "arch": res["cfg"].name,
                    "d_model": res["cfg"].d_model, "layers": layers, "steps": steps,
                    "k6_launches": launched[0], "k6_bwd_launches": launched[1],
                    "initial_loss": first, "final_loss": last,
                    "tokens_per_s": res["tokens_per_s"], "seconds": res["seconds"],
                    "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    emit(out)
    return (out["sync"]["k1_launches"], out["async"]["k2_launches"],
            sum(out[n]["k6_launches"] for n in ("sync", "async", "train")),
            sum(out[n]["k6_bwd_launches"] for n in ("sync", "async", "train")))


# ---------------------------------------------------------------------------
# slice G3: the other LM families (gemma3's windows, MoE, MLA, the hybrid
# jamba, the vision stub, whisper's encoder-decoder)
# ---------------------------------------------------------------------------

G3_ARCH = "gemma3-27b"
G3_WINDOW = 1024
G3_K4_SHAPE = (2, 16, 2, 2048, 128)  # gemma3's prefill and training: (B, Hk, G, S, D)
G3_K5_SHAPE = (2, 16, 2, 1024, 128)  # gemma3's decode on a window ring
G3_PREFILL = (2, 2048)
G3_DECODE_STEPS = 32
G3_TRAIN_SHAPE = (2, 2048)
G3_TRAIN_STEPS = 3
G3_TRAIN_LR = 3e-2
G3_FAMILY_PREFILL = 2048  # the (1, 2048) prefills of deepseek-v2, jamba and pixtral
G3_FAMILY_DECODE = 8
G3_CHECK_S = 512  # the prompt of deepseek-v2's absorbed-vs-decompressed check
# the no-drop check's prompt: MoE groups are min(128, tokens), so S and
# S - 1 both split into whole groups only up to 128 tokens
G3_NODROP_S = 128


def _by_shape(new, old):
    """``old`` in a tensor shaped as ``new`` (``old``'s dtype): whole, or
    along the one axis where the ring of ``new`` is longer."""
    new = new.to(old.dtype)
    diff = [i for i, (a, b) in enumerate(zip(new.shape, old.shape)) if a != b]
    (new.narrow(diff[0], 0, old.shape[diff[0]]) if diff else new).copy_(old)
    return new


def _grown(model, caches, batch, ctx):
    """A prefill's caches in a fresh ring of ``ctx`` slots: the prefill's
    ring has one slot a prompt token, so a decode step straight after it
    would overwrite position 0 of a full layer. Position p stays at slot p
    (at p mod W in a window ring, whose length does not change)."""
    from repro_torch.core.tree import tree_map

    return tree_map(_by_shape, model.init_decode_caches(batch, ctx, "cuda"), caches)


def _g3_counts(k4, k5, k6):
    """(K4 forward, K4 backward, K5, K6 forward) launches."""
    return (k4.launches, k4.bwd_launches, k5.launches, k6.launches)


def _zero(*mods):
    for m in mods:
        m.launches = 0
        if hasattr(m, "bwd_launches"):
            m.bwd_launches = 0


def _free(torch):
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _last_step_gap(model, params, toks, full=None):
    """Prefill of S tokens against prefill of S - 1 plus one decode step of
    token S - 1 (the prefill's ring grown by a slot): the max abs logit
    gap, the logits' largest magnitude and top-1 agreement. ``full`` is the
    prefill of S's logits when the caller has them."""
    B, S = toks.shape
    if full is None:
        full, _ = model.prefill(params, {"tokens": toks})
    _, caches = model.prefill(params, {"tokens": toks[:, :-1]})
    step, _ = model.decode_step(params, _grown(model, caches, B, S), toks[:, -1:])
    full, step = full.float(), step.float()
    return {"max_abs_gap": float((full - step).abs().max()),
            "max_abs_logit": float(full.abs().max()),
            "top1_agree": float((full.argmax(-1) == step.argmax(-1)).float().mean())}


def _consistent(gap) -> bool:
    return gap["max_abs_gap"] <= CONSISTENCY_TOL * (1 + gap["max_abs_logit"])


def phase_g3_serve(torch, k4, k5):
    """gemma3-27b at full width and depth (62 layers: 52 sliding, W = 1024,
    and 10 full; bf16, weights from seed 0): ``model.prefill`` at
    G3_PREFILL with 62 K4 launches and none of K5, then G3_DECODE_STEPS
    greedy decode steps on the prefill's caches grown to their context, 62
    K5 launches a step (sliding rings of L = W and full rings: each a
    prefix); no plain or kernel-off attention, no host sync in a decode
    step; prefill tokens/s, decode ms a step, the device-busy share of
    decode steps, peak memory (the init's apart). Consistency: in f32 with
    TF32 off, on one repeat of the pattern at full width (the 6-layer
    pattern and the 2-layer remainder; the full depth does not fit in f32),
    prefill of S - 1 tokens plus one decode step against prefill of S =
    2048 within CONSISTENCY_TOL (relative to the largest logit); the same
    gap of the full-depth bf16 model is reported beside it."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import factory

    t_phase = time.time()
    cfg = get_arch(G3_ARCH)
    n_layers = cfg.num_layers
    B, S = G3_PREFILL
    toks = torch.randint(0, cfg.vocab_size, (B, S), device="cuda", dtype=torch.int32,
                         generator=torch.Generator(device="cuda").manual_seed(1))
    # (a) f32 consistency on one repeat of the pattern
    cut = dataclasses.replace(cfg, repeats=1)
    m32 = factory.build(cut)
    with _TF32(torch, {"cudnn": False, "matmul": False}), torch.no_grad():
        p32 = tree_map(lambda t: t.float(), m32.init(
            torch.Generator(device="cuda").manual_seed(0)))
        gap32 = _last_step_gap(m32, p32, toks)
    del p32
    if not _consistent(gap32):
        raise AssertionError(f"g3_serve: f32 prefill vs prefill + decode gap {gap32}")
    _free(torch)

    # (b) full depth, bf16
    model = factory.build(cfg)
    t0 = time.time()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.time() - t0
    init_peak = torch.cuda.max_memory_allocated() / 2**30
    param_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    plain = {}
    restore = [_count_calls(k4, ["flash_attention_plain"], plain),
               _count_calls(k5, ["flash_decode_plain"], plain),
               _count_calls(attn_mod, ["_attend_direct", "_attend_flash_jnp"], plain)]
    try:
        with torch.no_grad():
            prefill = lambda: model.prefill(params, {"tokens": toks})  # noqa: E731
            prefill()  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _zero(k4, k5)
            t0 = time.perf_counter()
            logits, caches = prefill()
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            k4_prefill, k5_prefill = k4.launches, k5.launches
            if k4_prefill != n_layers or k5_prefill:
                raise AssertionError(f"g3_serve: prefill launched K4 {k4_prefill} and K5 "
                                     f"{k5_prefill} times ({n_layers} layers)")
            if not bool(torch.isfinite(logits).all()) or logits.shape != (B, 1, cfg.vocab_size):
                raise AssertionError("g3_serve: prefill logits not finite / of shape")
            caches = _grown(model, caches, B, S + G3_DECODE_STEPS + 8)
            tok = logits[:, -1:].argmax(-1).to(torch.int32)
            _zero(k4, k5)
            out = []
            t0 = time.perf_counter()
            for _ in range(G3_DECODE_STEPS):
                lg, caches = model.decode_step(params, caches, tok)
                tok = lg[:, -1:].argmax(-1).to(torch.int32)
                out.append(tok)
            toks_out = torch.cat(out, 1).cpu()  # the loop's one sync
            decode_s = time.perf_counter() - t0
            k5_decode, k4_decode = k5.launches, k4.launches
            peak = torch.cuda.max_memory_allocated() / 2**30
            if k5_decode != n_layers * G3_DECODE_STEPS or k4_decode:
                raise AssertionError(f"g3_serve: {G3_DECODE_STEPS} decode steps launched K5 "
                                     f"{k5_decode} and K4 {k4_decode} times")
            if plain:
                raise AssertionError(f"g3_serve: plain or kernel-off attention ran: {plain}")
            state = {"c": caches}

            def step():
                _, state["c"] = model.decode_step(params, state["c"], tok)

            syncs = _syncs_in(torch, lambda: [step() for _ in range(2)])
            if syncs:
                raise AssertionError(f"g3_serve: decode_step synchronized: {syncs[:3]}")
            d_union, d_window, d_by, d_kernels = _profile(torch, step, 5)
            del caches, state
    finally:
        for fn in restore:
            fn()
    with torch.no_grad():
        gap16 = _last_step_gap(model, params, toks, full=logits)
    if not ((toks_out >= 0) & (toks_out < cfg.vocab_size)).all():
        raise AssertionError("g3_serve: tokens out of range")
    kinds = [s.attn.kind for s in cfg.all_layers()]
    emit({"phase": "g3_serve", "ok": True, "arch": cfg.name, "layers": n_layers,
          "layer_kinds": {k: kinds.count(k) for k in sorted(set(kinds))},
          "window": G3_WINDOW, "params": sum(t.numel() for t in tree_leaves(params)),
          "param_gb": param_bytes / 1e9, "init_s": init_s, "init_peak_gib": init_peak,
          "prefill": {"batch": B, "seq": S, "k4_launches": k4_prefill, "k5_launches": 0,
                      "ms": prefill_s * 1e3, "tokens_per_s": B * S / prefill_s},
          "decode": {"batch": B, "steps": G3_DECODE_STEPS, "k5_launches": k5_decode,
                     "k5_launches_per_step": k5_decode / G3_DECODE_STEPS,
                     "ms_per_step": decode_s * 1e3 / G3_DECODE_STEPS,
                     "weight_read_bound_ms_per_step": param_bytes / HBM_BYTES_PER_S * 1e3,
                     "first_tokens": toks_out[0, :8].tolist()},
          "decode_profile_5_steps": {
              "device_union_ms_per_step": d_union / 5, "window_ms_per_step": d_window / 5,
              "device_busy_share": d_union / d_window,
              "k5_share_of_device_time": _share(d_by, "decode_kernel"),
              "kernels_per_step": d_kernels / 5},
          "peak_mem_gib": peak, "host_syncs_in_2_decode_steps": 0, "plain_calls": 0,
          "consistency": {"f32_one_repeat": {**gap32, "layers": cut.num_layers,
                                             "tolerance": CONSISTENCY_TOL, "tf32": False},
                          "bf16_full_depth_reported": gap16},
          "seconds": time.time() - t_phase})
    del params, logits
    _free(torch)
    return k4_prefill, k5_decode


def phase_g3_train(torch, k4):
    """gemma3-27b at full width with depth cut to one repeat (the 6-layer
    pattern and the 2-layer remainder: 7 sliding layers of W = 1024 and one
    full; bf16, weights from seed 0; full depth cannot hold params,
    gradients and new params on one card), G3_TRAIN_STEPS
    ``sgd_train_step``s on one batch at G3_TRAIN_SHAPE with remat: K4
    forward 2 x 6 (the repeated layers, recomputed) + 2 (the remainder) and
    backward 8 launches a step, with W < S so the window mask is real; no
    plain attention; the loss falls, params (so gradients) stay finite and
    move; ms a step, tokens/s, peak memory."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import factory

    t_phase = time.time()
    cfg = dataclasses.replace(get_arch(G3_ARCH), repeats=1)
    model = factory.build(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(t.numel() for t in tree_leaves(params))
    B, S = G3_TRAIN_SHAPE
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), device="cuda", dtype=torch.int32,
                         generator=torch.Generator(device="cuda").manual_seed(2))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    lr = torch.full((), G3_TRAIN_LR, device="cuda")
    want = (2 * len(cfg.pattern) + len(cfg.remainder), cfg.num_layers)
    plain = {}
    restore = [_count_calls(k4, ["flash_attention_plain", "flash_attention_bwd_plain"], plain),
               _count_calls(attn_mod, ["_attend_direct", "_attend_flash_jnp"], plain)]
    first = [t.clone() for t in tree_leaves(params)[:3]]
    torch.cuda.reset_peak_memory_stats()
    try:
        per_step, losses = [], []
        _zero(k4)
        for _ in range(G3_TRAIN_STEPS):
            f0, b0 = k4.launches, k4.bwd_launches
            t0 = time.perf_counter()
            params, metrics = model.sgd_train_step(params, batch, lr)
            torch.cuda.synchronize()
            per_step.append((time.perf_counter() - t0) * 1e3)
            launched = (k4.launches - f0, k4.bwd_launches - b0)
            if launched != want:
                raise AssertionError(f"g3_train: K4 forward/backward launched {launched} "
                                     f"times in a step (want {want})")
            losses.append(float(metrics["loss"]))
        counts = (k4.launches, k4.bwd_launches)
        if plain:
            raise AssertionError(f"g3_train: plain or kernel-off attention ran: {plain}")
    finally:
        for fn in restore:
            fn()
    peak = torch.cuda.max_memory_allocated() / 2**30
    leaves = tree_leaves(params)
    if not (all(map(math.isfinite, losses)) and all(bool(torch.isfinite(t).all())
                                                   for t in leaves)):
        raise AssertionError(f"g3_train: non-finite loss {losses} or params (gradients)")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"g3_train: the loss did not fall: {losses}")
    if all(torch.equal(a, b) for a, b in zip(first, leaves[:3])):
        raise AssertionError("g3_train: the params did not move")
    ms = statistics.median(per_step[1:])
    emit({"phase": "g3_train", "ok": True, "arch": cfg.name, "layers": cfg.num_layers,
          "depth_cut": "one repeat of the 6-layer pattern plus the 2-layer remainder",
          "params": n_params, "batch": B, "seq": S, "window": G3_WINDOW,
          "steps": G3_TRAIN_STEPS, "lr": G3_TRAIN_LR, "remat": True,
          "same_batch_each_step": True, "k4_launches_per_step": want[0],
          "k4_bwd_launches_per_step": want[1], "plain_calls": 0, "losses": losses,
          "ms_per_step": ms, "ms_per_step_all": per_step, "tokens_per_s": B * S / ms * 1e3,
          "peak_mem_gib": peak, "seconds": time.time() - t_phase})
    del params, batch
    _free(torch)
    return counts


def _family_run(torch, model, params, batch, steps, kernels):
    """``model.prefill`` of ``batch`` (timed after a warm-up prefill), then
    ``steps`` greedy decode steps on the prefill's caches grown to their
    context. Returns the ``_g3_counts`` of the timed prefill and of the
    decode steps, and the times."""
    B = batch["tokens"].shape[0]
    S = batch["tokens"].shape[1] + (batch["frontend"].shape[1] if "frontend" in batch else 0)
    with torch.no_grad():
        model.prefill(params, batch)
        torch.cuda.synchronize()
        _zero(*kernels)
        t0 = time.perf_counter()
        logits, caches = model.prefill(params, batch)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        pre = _g3_counts(*kernels)
        caches = _grown(model, caches, B, S + steps)
        tok = logits[:, -1:].argmax(-1).to(torch.int32)
        _zero(*kernels)
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, caches = model.decode_step(params, caches, tok)
            tok = logits[:, -1:].argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        dec = _g3_counts(*kernels)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"g3_families: {model.cfg.name} logits not finite")
    return pre, dec, {"prefill_ms": prefill_s * 1e3,
                      "prefill_tokens_per_s": B * S / prefill_s,
                      "decode_ms_per_step": decode_s * 1e3 / steps}


def _deepseek_checks(torch, cfg, params):
    """deepseek-v2's f32 checks (TF32 off) at G3_CHECK_S tokens: absorbed
    against decompressed MLA decode over G3_FAMILY_DECODE steps from the
    same caches, and, on a copy with capacity_factor = E / top_k (no route
    dropped, so a prefill's group and a decode step's group of one route
    alike), prefill of G3_NODROP_S tokens against prefill of one fewer
    plus a decode step; both within CONSISTENCY_TOL of the largest
    logit."""
    import dataclasses

    from repro_torch.core.tree import tree_map
    from repro_torch.models import factory

    S, n = G3_CHECK_S, G3_FAMILY_DECODE
    toks = torch.randint(0, cfg.vocab_size, (1, S + n), device="cuda", dtype=torch.int32,
                         generator=torch.Generator(device="cuda").manual_seed(7))
    with _TF32(torch, {"cudnn": False, "matmul": False}), torch.no_grad():
        p32 = tree_map(lambda t: t.float(), params)
        routes = {}
        for absorb in (True, False):
            m = factory.build(cfg, mla_absorb=absorb)
            _, c = m.prefill(p32, {"tokens": toks[:, :S]})
            c, outs = _grown(m, c, 1, S + n), []
            for t in range(S, S + n):
                lg, c = m.decode_step(p32, c, toks[:, t:t + 1])
                outs.append(lg.float())
            routes[absorb] = torch.cat(outs, 1)
        absorb_gap = {"max_abs_gap": float((routes[True] - routes[False]).abs().max()),
                      "max_abs_logit": float(routes[True].abs().max())}
        if not _consistent(absorb_gap):
            raise AssertionError(f"g3_families: MLA absorbed vs decompressed decode "
                                 f"{absorb_gap}")
        spec = cfg.pattern[0].mlp.moe
        cf = spec.num_experts / spec.top_k
        nodrop = dataclasses.replace(cfg, pattern=tuple(
            dataclasses.replace(s, mlp=dataclasses.replace(s.mlp, moe=dataclasses.replace(
                s.mlp.moe, capacity_factor=cf)))
            for s in cfg.pattern))
        gap = _last_step_gap(factory.build(nodrop), p32, toks[:, :G3_NODROP_S])
        if not _consistent(gap):
            raise AssertionError(f"g3_families: no-drop MoE prefill vs decode {gap}")
    del p32
    return {"seq": S, "dtype": "float32", "tf32": False, "tolerance": CONSISTENCY_TOL,
            "absorbed_vs_decompressed": {"steps": n, **absorb_gap},
            "no_drop_prefill_vs_decode": {"seq": G3_NODROP_S, "capacity_factor": cf, **gap}}


def phase_g3_families(torch, k4, k5, k6):
    """One run per family, each freed before the next; per family its
    seconds, peak memory and kernel launches (held exactly):

    deepseek-v2 at full width, depth cut to its dense prefix plus one MoE
    layer (MLA: no K4, no K5): prefill (1, 2048) and G3_FAMILY_DECODE
    decode steps in bf16, ``_deepseek_checks`` in f32, an
    ``sgd_train_step`` at (1, 2048) timed twice from the same params; jamba at full width, one repeat (8
    layers: 7 mamba, 1 attention without RoPE; MoE on alternate layers):
    prefill (1, 2048) with K6 x 7 and K4 x 1, decode steps with K5 x 1
    each; pixtral-12b at full width and depth: prefill of 256 frontend
    embeddings and 1792 tokens (K4 x 40), decode (K5 x 40 a step);
    whisper-tiny at full size through ``launch.serve.serve`` with frames
    and a 128-token prompt (the decoder's prefill self-attention on K4 x 4,
    the bidirectional encoder on no kernel), then 16 greedy decode steps
    (K5 x 4 a step); llama4 reduced (at full width one repeat holds two
    16.1 B-parameter MoE layers, about 70 GB before the stacking copy):
    prefill of 16 frontend embeddings and 112 tokens (chunked layers of
    W = 32: K4 x 2), decode (rings of L = W: K5 x 2 a step)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import factory

    out, totals = {}, [0, 0, 0, 0]  # K4, K4 backward, K5, K6
    kernels = (k4, k5, k6)
    n_dec = G3_FAMILY_DECODE

    def seeded(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    def tokens(cfg, B, n, seed):
        return torch.randint(0, cfg.vocab_size, (B, n), device="cuda", dtype=torch.int32,
                             generator=seeded(seed))

    def held(name, pre, dec, want_pre, want_dec):
        if pre != want_pre or dec != want_dec:
            raise AssertionError(f"g3_families: {name} launched (K4, K4 bwd, K5, K6) {pre} "
                                 f"in the prefill and {dec} in the decode steps, want "
                                 f"{want_pre} and {want_dec}")
        for i in range(4):
            totals[i] += pre[i] + dec[i]
        return {"prefill_k4": pre[0], "prefill_k6": pre[3], "decode_k5": dec[2]}

    def n_params(params):
        return sum(t.numel() for t in tree_leaves(params))

    # deepseek-v2: the dense prefix layer and one MoE layer
    t0 = time.time()
    cfg = dataclasses.replace(get_arch("deepseek-v2-236b"), repeats=1)
    model = factory.build(cfg)
    params = model.init(seeded(0))
    pre, dec, times = _family_run(torch, model, params,
                                  {"tokens": tokens(cfg, 1, G3_FAMILY_PREFILL, 1)}, n_dec,
                                  kernels)
    launched = held("deepseek-v2", pre, dec, (0, 0, 0, 0), (0, 0, 0, 0))
    serve_peak = torch.cuda.max_memory_allocated() / 2**30
    checks = _deepseek_checks(torch, cfg, params)
    _free(torch)
    toks = tokens(cfg, 1, G3_FAMILY_PREFILL + 1, 2)
    train_ms = []
    for _ in range(2):  # the first step warms up the backward's kernels
        t1 = time.perf_counter()
        new, metrics = model.sgd_train_step(params, {"tokens": toks[:, :-1],
                                                     "labels": toks[:, 1:]}, 1e-2)
        torch.cuda.synchronize()
        train_ms.append((time.perf_counter() - t1) * 1e3)
    if not (math.isfinite(float(metrics["loss"])) and float(metrics["moe_aux"]) > 0
            and all(bool(torch.isfinite(t).all()) for t in tree_leaves(new))):
        raise AssertionError(f"g3_families: deepseek-v2's train step: {metrics}")
    out["deepseek-v2"] = {
        "layers": cfg.num_layers, "params": n_params(params),
        "prefill": [1, G3_FAMILY_PREFILL], "decode_steps": n_dec, **times,
        "launches": launched, "serve_peak_mem_gib": serve_peak, "f32_checks": checks,
        "train_step": {"seq": G3_FAMILY_PREFILL, "ms_first_then_second": train_ms,
                       "loss": float(metrics["loss"]), "moe_aux": float(metrics["moe_aux"]),
                       "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30},
        "seconds": time.time() - t0}
    del model, params, new
    _free(torch)

    # jamba: one repeat of the 8-layer pattern
    t0 = time.time()
    cfg = dataclasses.replace(get_arch("jamba-v0.1-52b"), repeats=1)
    model = factory.build(cfg)
    params = model.init(seeded(0))
    n_mamba = sum(s.kind == "mamba" for s in cfg.all_layers())
    n_attn = cfg.num_layers - n_mamba
    pre, dec, times = _family_run(torch, model, params,
                                  {"tokens": tokens(cfg, 1, G3_FAMILY_PREFILL, 3)}, n_dec,
                                  kernels)
    out["jamba"] = {
        "layers": cfg.num_layers, "mamba_layers": n_mamba, "attn_layers": n_attn,
        "params": n_params(params), "prefill": [1, G3_FAMILY_PREFILL],
        "decode_steps": n_dec, **times,
        "launches": held("jamba", pre, dec, (n_attn, 0, 0, n_mamba),
                         (0, 0, n_attn * n_dec, 0)),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "seconds": time.time() - t0}
    del model, params
    _free(torch)

    # pixtral-12b: full width and depth, the vision stub's embeddings first
    t0 = time.time()
    cfg = get_arch("pixtral-12b")
    model = factory.build(cfg)
    params = model.init(seeded(0))
    ft, L = cfg.frontend_tokens, cfg.num_layers
    batch = {"tokens": tokens(cfg, 1, G3_FAMILY_PREFILL - ft, 4),
             "frontend": torch.randn((1, ft, cfg.d_model), generator=seeded(5),
                                     device="cuda").to(torch.bfloat16)}
    pre, dec, times = _family_run(torch, model, params, batch, n_dec, kernels)
    out["pixtral-12b"] = {
        "layers": L, "params": n_params(params), "frontend_tokens": ft,
        "text_tokens": G3_FAMILY_PREFILL - ft, "decode_steps": n_dec, **times,
        "launches": held("pixtral-12b", pre, dec, (L, 0, 0, 0), (0, 0, L * n_dec, 0)),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "seconds": time.time() - t0}
    del model, params
    _free(torch)

    # whisper-tiny: the serve driver, frames drawn from its seed
    t0 = time.time()
    cfg = get_arch("whisper-tiny")
    L, gen = cfg.num_layers, 16
    _zero(*kernels)
    res = serve_mod.serve(cfg, 4, 128, gen, temperature=0.0, device="cuda", seed=0)
    launched = held("whisper-tiny", _g3_counts(*kernels), (0, 0, 0, 0),
                    (L, 0, L * gen, 0), (0, 0, 0, 0))
    if not ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all():
        raise AssertionError("g3_families: whisper-tiny's tokens out of range")
    out["whisper-tiny"] = {
        "decoder_layers": L, "encoder_layers": cfg.encoder.num_layers,
        "frames": cfg.encoder.source_len, "batch": 4, "prompt_len": 128, "gen": gen,
        "prefill_ms": res.prefill_s * 1e3, "decode_ms_per_step": res.decode_s * 1e3 / gen,
        "launches": {"prefill_k4": launched["prefill_k4"], "decode_k5": L * gen},
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "seconds": time.time() - t0}
    _free(torch)

    # llama4, reduced
    t0 = time.time()
    cfg = get_arch("llama4-maverick-400b-a17b").reduced()
    model = factory.build(cfg)
    params = model.init(seeded(0))
    ft, L = cfg.frontend_tokens, cfg.num_layers
    batch = {"tokens": tokens(cfg, 2, 128 - ft, 6),
             "frontend": torch.randn((2, ft, cfg.d_model), generator=seeded(7), device="cuda")}
    pre, dec, times = _family_run(torch, model, params, batch, n_dec, kernels)
    out["llama4-reduced"] = {
        "layers": L, "d_model": cfg.d_model, "dtype": cfg.param_dtype,
        "kinds": [s.attn.kind for s in cfg.all_layers()],
        "window": cfg.pattern[0].attn.window, "batch": 2, "seq": 128,
        "frontend_tokens": ft, "decode_steps": n_dec, **times,
        "launches": held("llama4", pre, dec, (L, 0, 0, 0), (0, 0, L * n_dec, 0)),
        "seconds": time.time() - t0}
    del model, params
    _free(torch)
    emit({"phase": "g3_families", "ok": True, **out})
    return totals


def phase_g3_pool(torch, k5):
    """The slot pool's contracts (``serve_contracts``: join/evict churn
    bitwise each stream's solo decode in a same-width pool, failover under
    ``replica_crash`` equal to the calm run) for a windowed arch (gemma3),
    an MLA + MoE arch (deepseek-v2: each row its own MoE group) and the
    encoder-decoder (whisper), reduced, on the card: K5 once per non-MLA
    layer a decode step, no plain version."""
    from repro_torch.configs import get_arch
    from repro_torch.models import encdec, factory, transformer

    t_phase = time.time()
    out, total = {}, 0
    for name in ("gemma3-27b", "deepseek-v2-236b", "whisper-tiny"):
        cfg = get_arch(name).reduced()
        model = factory.build(cfg)
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        store = _ring_store(torch, params, SERVE_RING_H)
        del params
        k5_layers = sum(not s.attn.is_mla for s in cfg.all_layers() if s.attn is not None)
        counts, plain = {}, {}
        restore = [_count_calls(transformer, ["decode_step"], counts),
                   _count_calls(encdec, ["decode_step"], counts),
                   _count_calls(k5, ["flash_decode_plain"], plain)]
        try:
            k5.launches = 0
            contracts = serve_contracts(model, store, "cuda")
            steps = sum(counts.values())
            if k5.launches != k5_layers * steps:
                raise AssertionError(f"g3_pool: {name}: K5 launched {k5.launches} times in "
                                     f"{steps} decode steps of {k5_layers} K5 layers")
            if plain:
                raise AssertionError(f"g3_pool: {name}: plain versions ran: {plain}")
        finally:
            for fn in restore:
                fn()
        total += k5.launches
        out[name] = {**contracts, "decode_steps": steps, "k5_layers": k5_layers,
                     "k5_launches": k5.launches}
        del store, model
    _free(torch)
    emit({"phase": "g3_pool", "ok": True, "archs": out, "seconds": time.time() - t_phase})
    return total


TP_FAMILIES = ("tinyllama-1.1b", "gemma3-27b", "deepseek-v2-236b", "jamba-v0.1-52b",
               "mamba2-370m", "whisper-tiny")
TP_TOL = 1e-5  # relative to each leaf's max, f32
TP_LOOSE = {"whisper-tiny": 5e-5}  # its f32 cross-attention gradients (tests/test_torch_tp.py)
TP_CONTRACT_SHAPE = (2, 128, 32, 8)  # (B, S of the loss, S of the prefill, decode steps)
TP_MESHES = ({"data": 1, "model": 4}, {"data": 2, "model": 2})
TP_DECODE_STEPS = 32  # tp_main's decode steps, from the prefill's caches
TP_LOSS_TOL = 1e-2  # bf16 loss against a world of one, relative
# a sharded bf16 run's logits against an f32 world of one on the same
# weights: within this many times the bf16 world of one's gap from it (each
# bf16 run rounds on its own; a sharding fault is a gap of order one)
TP_WITNESS = 2.0


def _tp_case(torch, name, mesh=None):
    """A reduced family's contract case: the port's params from seed 0 (host
    tensors), tokens from a numpy seed, in f32 on the card."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.models import factory

    cfg = configs.get_arch(name).reduced()
    B, S, P, steps = TP_CONTRACT_SHAPE
    rng = np.random.default_rng(1)

    def ints(shape):
        return torch.from_numpy(rng.integers(0, cfg.vocab_size, shape).astype(np.int32))

    batch = {"tokens": ints((B, S)), "labels": ints((B, S))}
    pre = {"tokens": ints((B, P))}
    if cfg.encoder is not None:
        frames = lambda: torch.from_numpy(  # noqa: E731
            rng.standard_normal((B, cfg.encoder.source_len, cfg.d_model)).astype(np.float32))
        batch["frames"], pre["frames"], pre["seq_len"] = frames(), frames(), P + steps
    return {"name": name, "cfg": cfg, "mesh": mesh,
            "params": factory.build(cfg).init(torch.Generator().manual_seed(0)),
            "batch": batch, "prefill": pre, "decode": ints((steps, B, 1)), "lr": 0.1,
            "device": "cuda", "deterministic": True}


def _tp_bitwise(torch, a, b) -> bool:
    from repro_torch.core.tree import tree_paths

    keys = ("loss", "moe_aux", "grads", "new_params", "prefill_logits", "caches",
            "decode_logits", "decode_caches")
    return all(torch.equal(x, y) for k in keys
               for (_, x), (_, y) in zip(tree_paths(a[k]), tree_paths(b[k])))


def phase_tp_contracts(torch):
    """Slice I1's contracts of the sharded LM step on the card (module
    docstring), TF32 off and deterministic algorithms on inside (restored
    after)."""
    import tempfile

    from repro_torch.core.distributed import world_of_one
    from repro_torch.launch import tp_cases

    t0 = time.time()
    cases = {n: _tp_case(torch, n) for n in TP_FAMILIES}
    saved = torch.are_deterministic_algorithms_enabled()
    checks = {}
    with _TF32(torch, {"cudnn": False, "matmul": False}):
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            one = {n: tp_cases.run_case(c, sharded=False) for n, c in cases.items()}
            with world_of_one("cuda"):
                for n, c in cases.items():
                    got = tp_cases.run_case(dict(c, mesh={"data": 1, "model": 1}), sharded=True)
                    checks[f"1/{n}"] = {"backend": "nccl", "bitwise": _tp_bitwise(torch, got, one[n]),
                                        "collectives": got["counts"]}
        finally:
            torch.use_deterministic_algorithms(saved)
    worlds = {2: [dict(c, mesh={"data": 1, "model": 2}, name=f"model2/{n}")
                  for n, c in cases.items()],
              4: [dict(c, mesh=m, name=f"data{m['data']}xmodel{m['model']}/{n}")
                  for m in TP_MESHES for n, c in cases.items()]}
    worlds[4].append(dict(cases["deepseek-v2-236b"], mesh=TP_MESHES[1], name="repeat"))
    import threading

    results, errors = {}, []

    def spawn(world, tmp):
        try:
            results[world] = tp_cases.run_cases_on_ranks(
                worlds[world], world, tmp, devices=["cuda:0"] * world, timeout=900)
        except BaseException as e:  # raised below, in this thread
            errors.append(e)

    with tempfile.TemporaryDirectory() as tmp:  # both worlds at once, on the one card
        threads = [threading.Thread(target=spawn, args=(w, tmp)) for w in worlds]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    if errors:
        raise errors[0]
    for world, todo in worlds.items():
        got = results[world]
        for c, r in zip(todo, got):
            if c["name"] == "repeat":
                checks["repeat"] = {"bitwise": _tp_bitwise(
                    torch, r, got[[x["name"] for x in todo].index(
                        "data2xmodel2/deepseek-v2-236b")])}
                continue
            fam = c["name"].split("/")[1]
            tol = TP_LOOSE.get(fam, TP_TOL)
            worst = {}
            for key in ("loss", "moe_aux", "grads", "new_params", "prefill_logits",
                        "caches", "decode_logits", "decode_caches"):
                gaps = tp_cases.leaf_gaps(r[key], one[fam][key])
                worst[key] = max(gaps.values()) if gaps else 0.0
            checks[c["name"]] = {"backend": "gloo (host-staged)", "tolerance": tol,
                                 "worst": worst, "roundtrip": r["roundtrip"],
                                 "ok": all(v <= tol for v in worst.values())
                                 and r["roundtrip"],
                                 "psum_bytes": r["counts_train"].get("psum", {}).get("bytes")}
    bad = [n for n, c in checks.items() if not c.get("ok", c.get("bitwise"))]
    if bad:
        raise AssertionError(f"tp_contracts: failed {bad}: {checks}")
    emit({"phase": "tp_contracts", "ok": True, "dtype": "float32",
          "shape": dict(zip(("B", "S_loss", "S_prefill", "decode_steps"), TP_CONTRACT_SHAPE)),
          "checks": checks, "seconds": time.time() - t0})


def _tp_kernel_checks(torch, k4, k5, k6, rank_shapes):
    """K4 forward and backward, K5 and K6 at the rank-local shapes of
    ``tp_main`` (bf16, the model's layouts) against their plain versions;
    returns the max errors (these launches are not the main path's)."""
    gen = torch.Generator(device="cuda").manual_seed(28)
    bf16 = torch.bfloat16
    errs = {}
    for shape in rank_shapes["k4"]:
        q, k, v = _model_layout(torch, gen, shape, bf16)
        kw = dict(scale=shape[-1] ** -0.5)
        errs[f"k4{shape}"] = _check_against_plain(
            torch, f"K4 {shape}", lambda: k4.flash_attention(q, k, v, **kw),
            lambda: k4.flash_attention_plain(q, k, v, **kw), bf16)
        dout = torch.randn(q.shape, generator=gen, device="cuda").to(bf16)
        out, lse = k4.flash_attention_with_lse(q, k, v, **kw)
        _, lse_plain = k4.flash_attention_plain(q.float(), k.float(), v.float(), **kw,
                                                return_lse=True)
        grads = k4.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        plain = k4.flash_attention_bwd_plain(q, k, v, out, lse_plain, dout, **kw)
        e = max(_rel_err(g, p) for g, p in zip(grads, plain))
        if e > BWD_TOL["bfloat16"]:
            raise AssertionError(f"K4 backward {shape}: {e} of the gradient's max")
        errs[f"k4_bwd{shape}"] = e
    for shape in rank_shapes["k5"]:
        q, k, v = _attn_inputs(torch, gen, shape, bf16, decode=True)
        vl = torch.tensor(shape[3], device="cuda")  # the ring full after the prompt
        kw = dict(scale=shape[-1] ** -0.5)
        errs[f"k5{shape}"] = _check_against_plain(
            torch, f"K5 {shape}", lambda: k5.flash_decode(q, k, v, vl, **kw),
            lambda: k5.flash_decode_plain(q, k, v, vl, **kw), bf16)
    for shape in rank_shapes["k6"]:
        x, dt, A, B_, C_ = _ssd_inputs(torch, gen, shape, bf16)
        y, _ = k6.ssd_scan(x, dt, A, B_, C_, 256)
        yp, _ = k6.ssd_chunked_plain(x, dt, A, B_, C_, 256)
        e = _rel_err(y, yp)
        if e > 2e-2:
            raise AssertionError(f"K6 {shape}: {e} of the output's max")
        errs[f"k6{shape}"] = e
    return errs


def phase_tp_main(torch, k4, k5, k6):
    """tinyllama-1.1b on two meshes of four ranks of cuda:0 and mamba2-370m on
    model 2 (module docstring). Returns the ranks' (K4 forward, K4 backward,
    K5, K6) launches summed, with the world of one's, and each tinyllama
    rank's collectives by phase ({mesh name: [(coords, counts)]})."""
    import tempfile

    from repro_torch.core.distributed import world_of_one
    from repro_torch.launch import tp_cases

    t0 = time.time()
    _free(torch)
    lm = {"op": "main_path", "arch": LM_ARCH, "train": TRAIN_SHAPE, "prefill": PREFILL_SHAPE,
          "decode": TP_DECODE_STEPS, "lr": LM_TRAIN_LR, "device": "cuda",
          "build": {"explicit_tp": True, "remat_save_outputs": True}}
    ssm = {"op": "main_path", "arch": SSM_ARCH, "prefill": PREFILL_SHAPE, "device": "cuda"}
    totals = {"k4": 0, "k4_bwd": 0, "k5": 0, "k6": 0}

    def add(rep):
        for launches in rep["launches"].values():
            for k, n in launches.items():
                totals[k] += n

    one = {"data": 1, "model": 1}
    with world_of_one("cuda"):  # the baseline: the same main path on one rank
        one_lm = tp_cases.main_path(dict(lm, mesh=one))
        _free(torch)
        one_ssm = tp_cases.main_path(dict(ssm, mesh=one))
        _free(torch)  # the witnesses: the same weights and tokens in f32
        f32_lm = tp_cases.main_path(dict(lm, mesh=one, train=None, f32=True))
        _free(torch)
        f32_ssm = tp_cases.main_path(dict(ssm, mesh=one, f32=True))
    for rep in (one_lm, one_ssm, f32_lm, f32_ssm):
        add(rep)
    _free(torch)
    with tempfile.TemporaryDirectory() as tmp:
        lm_ranks = tp_cases.run_cases_on_ranks(
            [dict(lm, mesh=m) for m in TP_MESHES], 4, tmp, devices=["cuda:0"] * 4,
            timeout=900, per_rank=True)
        ssm_ranks = tp_cases.run_cases_on_ranks(
            [dict(ssm, mesh={"data": 1, "model": 2})], 2, tmp, devices=["cuda:0"] * 2,
            timeout=600, per_rank=True)

    def gap(a, b):
        return float((a - b).abs().max() / b.abs().max())

    # the bf16 world of one's rounding, read against the f32 witness
    witness = {"prefill": gap(one_lm["prefill_logits"], f32_lm["prefill_logits"]),
               "decode": gap(one_lm["decode_logits"], f32_lm["decode_logits"]),
               "ssm_prefill": gap(one_ssm["prefill_logits"], f32_ssm["prefill_logits"])}
    report, bad = {"witness_f32_gaps": witness}, []
    rank_counts = {}
    B, S = TRAIN_SHAPE
    for mi, mesh in enumerate(TP_MESHES):
        dp, tp = mesh["data"], mesh["model"]
        k4_shape = (B // dp, 4 // tp, 8, S, 64)
        k5_shape = (PREFILL_SHAPE[0] // dp, 4 // tp, 8, 64)
        name = f"data{dp}xmodel{tp}"
        rows = []
        for ranks in lm_ranks:
            rep = ranks[mi]
            add(rep)
            rank_counts.setdefault(name, []).append((rep["coords"], rep["counts"]))
            lau, shp = rep["launches"], rep["shapes_by_phase"]
            row = {"rank": rep["rank"], "coords": rep["coords"], "launches": lau,
                   "k4_shapes": shp["train"].get("k4"), "k5_shapes": shp["decode"].get("k5"),
                   "ms": rep["ms"], "staged_through_host": True,
                   "peak_gib": rep["peak_gib"], "loss": rep["loss"],
                   "loss_gap": abs(rep["loss"] - one_lm["loss"]) / abs(one_lm["loss"]),
                   "prefill_logits_gap": gap(rep["prefill_logits"], one_lm["prefill_logits"]),
                   "decode_logits_gap": gap(rep["decode_logits"], one_lm["decode_logits"]),
                   "prefill_f32_gap": gap(rep["prefill_logits"], f32_lm["prefill_logits"]),
                   "decode_f32_gap": gap(rep["decode_logits"], f32_lm["decode_logits"]),
                   "collective_bytes": {ph: {k: v["bytes"] for k, v in c.items()}
                                        for ph, c in rep["counts"].items()}}
            want = {"train": {"k4": 44, "k4_bwd": 22}, "prefill": {"k4": 22},
                    "decode": {"k5": 22 * TP_DECODE_STEPS}}
            ok = all(lau[ph][k] == n for ph, d in want.items() for k, n in d.items())
            ok &= shp["train"].get("k4") == [k4_shape] == shp["prefill"].get("k4")
            ok &= shp["train"].get("k4_bwd") == [k4_shape]
            ok &= [tuple(x) for x in shp["decode"].get("k5", [])] == [k5_shape]
            ok &= row["loss_gap"] <= TP_LOSS_TOL and math.isfinite(rep["loss"])
            ok &= row["prefill_f32_gap"] <= TP_WITNESS * witness["prefill"]
            ok &= row["decode_f32_gap"] <= TP_WITNESS * witness["decode"]
            if not ok:
                bad.append((name, row))
            rows.append(row)
        report[name] = rows
    rows = []
    for ranks in ssm_ranks:
        rep = ranks[0]
        add(rep)
        shp = rep["shapes_by_phase"]["prefill"].get("k6")
        row = {"rank": rep["rank"], "launches": rep["launches"]["prefill"], "k6_shapes": shp,
               "ms": rep["ms"], "staged_through_host": True, "peak_gib": rep["peak_gib"],
               "prefill_logits_gap": gap(rep["prefill_logits"], one_ssm["prefill_logits"]),
               "prefill_f32_gap": gap(rep["prefill_logits"], f32_ssm["prefill_logits"])}
        if (row["launches"]["k6"] != 48
                or shp != [(PREFILL_SHAPE[0], PREFILL_SHAPE[1], 16, 64)]
                or not row["prefill_f32_gap"] <= TP_WITNESS * witness["ssm_prefill"]):
            bad.append(("mamba2 model2", row))
        rows.append(row)
    report["mamba2-370m model2"] = rows
    if bad:
        raise AssertionError(f"tp_main: {bad}")
    shapes = {"k4": sorted({r["k4_shapes"][0] for m in TP_MESHES
                            for r in report[f"data{m['data']}xmodel{m['model']}"]}),
              "k5": [(PREFILL_SHAPE[0] // m["data"], 4 // m["model"], 8, PREFILL_SHAPE[1], 64)
                     for m in TP_MESHES],
              "k6": [(PREFILL_SHAPE[0], PREFILL_SHAPE[1], 16, 64, 128)]}
    errs = _tp_kernel_checks(torch, k4, k5, k6, shapes)
    emit({"phase": "tp_main", "ok": True, "arch": LM_ARCH, "dtype": "bfloat16",
          "world_of_one": {"loss": one_lm["loss"], "ms": one_lm["ms"],
                           "launches": one_lm["launches"], "peak_gib": one_lm["peak_gib"],
                           "ssm_ms": one_ssm["ms"], "ssm_launches": one_ssm["launches"]},
          "meshes": report, "kernel_checks": errs, "seconds": time.time() - t0})
    _free(torch)
    return totals["k4"], totals["k4_bwd"], totals["k5"], totals["k6"], rank_counts


DRYRUN_COPY_BYTES = 2 * 2**30  # (a): the device-to-device copy
DRYRUN_MM = 8192  # (a): a bf16 (n, n) x (n, n) matmul
DRYRUN_SHARE_MAX = 1.05  # a measured rate above this share of its peak: a wrong constant
DRYRUN_PAIRS = (("tinyllama-1.1b", "train_4k"), ("mamba2-370m", "prefill_32k"))  # (d)


def _cost_diff(a, b, n=12):
    """The aten ops and kernels whose counts differ between two
    ``op_cost.analyze`` results (the first ``n``)."""
    out = []
    for key in ("ops", "kernels"):
        for name in sorted(set(a[key]) | set(b[key])):
            if a[key].get(name) != b[key].get(name):
                out.append((name, a[key].get(name), b[key].get(name)))
    return out[:n]


def phase_dryrun(torch, k4, tp_counts):
    """Slice I2 against the card (module docstring): (a) the constants, (b)
    meta == card for ``lm_train``'s step, (c) the dry-run's collectives ==
    ``tp_main``'s ranks', (d) two production pairs on the 16 x 16 mesh."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_dry_mesh
    from repro_torch.models import factory
    from repro_torch.roofline import hw, op_cost

    t0 = time.time()
    _free(torch)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    props = torch.cuda.get_device_properties(0)
    # (a) the data-sheet peaks against the card's own rates
    src = torch.empty(DRYRUN_COPY_BYTES, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    copy_ms = cuda_ms(torch, lambda: dst.copy_(src), calls=10, trials=5, warmup=3)
    del src, dst
    gen = torch.Generator(device="cuda").manual_seed(29)
    a, b = (torch.randn((DRYRUN_MM, DRYRUN_MM), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    mm_ms = cuda_ms(torch, lambda: torch.matmul(a, b), calls=10, trials=5, warmup=3)
    del a, b
    copy_rate = 2 * DRYRUN_COPY_BYTES / (copy_ms * 1e-3)  # read once, written once
    mm_rate = 2 * DRYRUN_MM**3 / (mm_ms * 1e-3)
    shares = {"copy_of_hbm_bw": copy_rate / hw.HBM_BW,
              "matmul_of_peak_bf16": mm_rate / hw.PEAK_FLOPS_BF16}
    if not all(v <= DRYRUN_SHARE_MAX for v in shares.values()):
        raise AssertionError(f"dryrun: a measured rate above its data-sheet peak: {shares}")
    _free(torch)

    # (b) lm_train's step on the card and on meta: the same counts
    cfg = get_arch(LM_ARCH)
    model = factory.build(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    B, S = TRAIN_SHAPE
    batches = [{k: v.contiguous() for k, v in bt.items()}
               for bt in _token_batches(torch, cfg.vocab_size, 4, B, S)]
    lr = torch.full((), LM_TRAIN_LR, device="cuda")
    per_step = []
    for bt in batches[:3]:
        t1 = time.perf_counter()
        model.sgd_train_step(params, bt, lr)
        torch.cuda.synchronize()
        per_step.append((time.perf_counter() - t1) * 1e3)
    f0, b0 = k4.launches, k4.bwd_launches
    card = op_cost.analyze(model.sgd_train_step, params, batches[3], lr)
    torch.cuda.synchronize()
    card_launches = (k4.launches - f0, k4.bwd_launches - b0)
    del card["out"], params
    _free(torch)
    m0, mb0 = k4.meta_launches, k4.meta_bwd_launches
    meta_batch = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                  for k, v in batches[3].items()}
    meta = op_cost.analyze(model.sgd_train_step, factory.abstract_params(cfg), meta_batch,
                           torch.empty((), device="meta"))
    meta_tally = (k4.meta_launches - m0, k4.meta_bwd_launches - mb0)
    L = cfg.num_layers
    same = {"flops": card["flops"] == meta["flops"], "bytes": card["bytes"] == meta["bytes"],
            "kernels": card["kernels"] == meta["kernels"],
            "k4_tally": meta_tally == card_launches == (2 * L, L)}
    if not all(same.values()):
        raise AssertionError(f"dryrun: meta and the card differ: {same}, K4 card "
                             f"{card_launches} meta {meta_tally}, flops {card['flops']} "
                             f"{meta['flops']}, bytes {card['bytes']} {meta['bytes']}, "
                             f"first differences (op, card, meta): {_cost_diff(card, meta)}")
    flops = meta["flops"] + sum(k["flops"] for k in meta["kernels"].values())
    nbytes = meta["bytes"] + sum(k["bytes"] for k in meta["kernels"].values())
    step_ms = statistics.median(per_step[1:])
    roof_s = max(flops / hw.PEAK_FLOPS_BF16, nbytes / hw.HBM_BW)

    # (c) the dry-run's collectives against tp_main's ranks, phase by phase
    build = {"explicit_tp": True, "remat_save_outputs": True}
    collectives, bad = {}, []
    for mesh in TP_MESHES:
        name = f"data{mesh['data']}xmodel{mesh['model']}"
        dry = dryrun.phase_counts(cfg, make_dry_mesh(mesh, 0), train=TRAIN_SHAPE,
                                  prefill=PREFILL_SHAPE, decode=TP_DECODE_STEPS, build=build)
        live = tp_counts[name]
        for coords, counts in live:
            if counts != dry:
                bad.append((name, coords, counts, dry))
        collectives[name] = {"ranks": len(live), "dry": dry}
    if bad or len(collectives) != len(TP_MESHES):
        raise AssertionError(f"dryrun: the dry-run's collectives differ from tp_main's "
                             f"ranks: {bad[:2]}")

    # (d) two production pairs on the 16 x 16 mesh
    pairs = {}
    for arch, shape in DRYRUN_PAIRS:
        r = dryrun.lower_pair(arch, shape, multi_pod=False)
        if r["status"] != "ok":
            raise AssertionError(f"dryrun: {arch} {shape}: {r}")
        pairs[f"{arch}.{shape}"] = {
            k: r["roofline"][k] for k in ("compute_s", "memory_s", "collective_s", "dominant")}
        pairs[f"{arch}.{shape}"].update(
            flops_per_device=r["flops_per_device"], bytes_per_device=r["bytes_per_device"],
            collective_bytes_total=r["roofline"]["collective_bytes_total"],
            peak_gib=r["memory"]["peak_bytes"] / 2**30, trace_s=r["trace_s"],
            kernels={k: v["launches"] for k, v in r["kernels"]["by_name"].items()})
    emit({"phase": "dryrun", "ok": True, "card": smi, "sms": props.multi_processor_count,
          "memory_bytes": props.total_memory,
          "constants": {"HBM_BW": hw.HBM_BW, "PEAK_FLOPS_BF16": hw.PEAK_FLOPS_BF16,
                        "PEAK_FLOPS_F32": hw.PEAK_FLOPS_F32, "HBM_BYTES": hw.HBM_BYTES,
                        "LINK_BW": hw.LINK_BW},
          "copy": {"bytes": DRYRUN_COPY_BYTES, "ms": copy_ms, "rate": copy_rate},
          "matmul": {"n": DRYRUN_MM, "ms": mm_ms, "rate": mm_rate}, "shares": shares,
          "meta_equals_card": {"arch": cfg.name, "shape": list(TRAIN_SHAPE), "remat": True,
                               "flops": meta["flops"], "bytes": meta["bytes"],
                               "kernels": meta["kernels"], "k4_card": list(card_launches),
                               "k4_meta": list(meta_tally),
                               "card_peak_bytes": card["memory"]["peak_bytes"],
                               "meta_peak_bytes": meta["memory"]["peak_bytes"]},
          "card_step": {"ms": step_ms, "ms_all": per_step,
                        "roofline_ms": roof_s * 1e3,
                        "compute_ms": flops / hw.PEAK_FLOPS_BF16 * 1e3,
                        "memory_ms": nbytes / hw.HBM_BW * 1e3,
                        "ratio_to_roofline": step_ms * 1e-3 / roof_s,
                        "bytes_convention": dryrun.BYTES_CONVENTION,
                        "label": "the card's measured step against the data-sheet roofline"},
          "collectives_equal": collectives, "pairs_16x16": pairs,
          "seconds": time.time() - t0})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    from repro_torch.kernels import aoi_topk, build, event_topk, fedavg_reduce
    from repro_torch.kernels import flash_attention, flash_decode, ssd_scan

    t0 = time.time()
    build.build_all()
    emit({"phase": "build", "ok": True, "seconds": time.time() - t0,
          "ptxas": {k: [ln.strip() for ln in v.splitlines()
                        if "Used" in ln or "C75" in ln
                        or ("spill" in ln and not ln.strip().startswith("0 bytes"))]
                    for k, v in build.ptxas_log.items()}})
    entry = phase_kernel(torch, event_topk)
    k1_entry = phase_kernel_k1(torch, fedavg_reduce)
    k3_entry = phase_kernel_k3(torch, aoi_topk)
    entry["launches"], calm = phase_main(torch, event_topk)
    k3_entry["launches"] = phase_async_oldest(torch, aoi_topk)
    k1_entry["launches"] = phase_sync_main(torch, fedavg_reduce)
    phase_parity(torch)
    phase_sync_parity(torch, fedavg_reduce)
    phase_fault_contracts(torch, fedavg_reduce)
    attack_rows = phase_sync_attack(torch, fedavg_reduce, calm["tf32"])
    phase_async_chaos(torch, event_topk, fedavg_reduce, calm)
    phase_topo_contracts(torch, fedavg_reduce)
    k1_entry["launches"] += phase_async_hier(torch, event_topk, fedavg_reduce, calm)
    k1_entry["launches"] += phase_sync_hier(torch, fedavg_reduce, calm["tf32"])
    phase_defense_contracts(torch, fedavg_reduce)
    k2, k1 = phase_async_defense(torch, event_topk, fedavg_reduce, calm)
    entry["launches"] += k2
    k1_entry["launches"] += k1
    k1_entry["launches"] += phase_sync_defense(torch, fedavg_reduce, calm["tf32"],
                                               attack_rows["fedavg"])
    from repro_torch.core.distributed import world_of_one

    with world_of_one("cuda"):  # slice F's NCCL world of one, ended after
        phase_shard_contracts(torch, fedavg_reduce)
        k2, k3 = phase_sharded_main(torch, event_topk, aoi_topk, calm)
    entry["launches"] += k2
    k3_entry["launches"] += k3
    del calm["params"]
    k4_entry = phase_kernel_k4(torch, flash_attention)
    k5_entry = phase_kernel_k5(torch, flash_decode)
    k4_entry["launches"], k5_entry["launches"] = phase_serve_main(
        torch, flash_attention, flash_decode)
    phase_serve_parity(torch, flash_attention, flash_decode)
    k6_entry = phase_kernel_k6(torch, ssd_scan)
    k6_entry["launches"], model, params = phase_ssm_serve_main(torch, ssd_scan)
    phase_ssm_parity(torch, ssd_scan, model, params)
    del model, params
    k5_entry["launches"] += phase_serve_loop(torch, flash_decode)
    k5_entry["launches"] += phase_serve_fleet(torch, flash_decode)
    bwd_entry = phase_kernel_k4_bwd(torch, flash_attention)
    fwd, bwd = phase_lm_train(torch, flash_attention)
    k4_entry["launches"] += fwd
    bwd_entry["launches"] = bwd
    phase_lm_grad_parity(torch, flash_attention)
    fwd, bwd = phase_train_main(torch, flash_attention)
    k4_entry["launches"] += fwd
    bwd_entry["launches"] += bwd
    k1, k2 = phase_fl_lm(torch, event_topk, fedavg_reduce)
    k1_entry["launches"] += k1
    entry["launches"] += k2
    k6_bwd_entry = phase_kernel_k6_bwd(torch, ssd_scan)
    fwd, k6_bwd_entry["launches"] = phase_ssm_train(torch, ssd_scan)
    k6_entry["launches"] += fwd
    phase_ssm_grad_parity(torch, ssd_scan)
    k1, k2, fwd, bwd = phase_fl_ssm(torch, event_topk, fedavg_reduce, ssd_scan)
    k1_entry["launches"] += k1
    entry["launches"] += k2
    k6_entry["launches"] += fwd
    k6_bwd_entry["launches"] += bwd
    _free(torch)
    fwd, k5 = phase_g3_serve(torch, flash_attention, flash_decode)
    k4_entry["launches"] += fwd
    k5_entry["launches"] += k5
    fwd, bwd = phase_g3_train(torch, flash_attention)
    k4_entry["launches"] += fwd
    bwd_entry["launches"] += bwd
    fwd, bwd, k5, k6 = phase_g3_families(torch, flash_attention, flash_decode, ssd_scan)
    k4_entry["launches"] += fwd
    bwd_entry["launches"] += bwd
    k5_entry["launches"] += k5
    k6_entry["launches"] += k6
    k5_entry["launches"] += phase_g3_pool(torch, flash_decode)
    _free(torch)
    phase_tp_contracts(torch)
    fwd, bwd, k5, k6, tp_counts = phase_tp_main(torch, flash_attention, flash_decode, ssd_scan)
    k4_entry["launches"] += fwd
    bwd_entry["launches"] += bwd
    k5_entry["launches"] += k5
    k6_entry["launches"] += k6
    phase_dryrun(torch, flash_attention, tp_counts)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{key: e[key] for key in keys}
                      for e in (entry, k1_entry, k4_entry, k5_entry, k3_entry, k6_entry,
                                bwd_entry, k6_bwd_entry)]})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
