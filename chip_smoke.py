#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure (no phase's error is
caught):

  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — nvcc builds every kernel source from the checkout
               (``src/repro_torch/kernels/csrc``), one nvcc per source,
               all started together; then one line per kernel of what
               ``-Xptxas -v`` reports (registers, static shared memory,
               spills) and the dynamic shared memory of the redesigned
               kernels (attention at their path's head dim, the copy
               engine's ring), and the blocks per SM of the f32 prefill
               and decode bodies and the combine kernel (no block of an
               f32 body fitting an SM fails);
  3. parity  — each kernel against its plain PyTorch version on the
               card: the paged-attention kernels in bf16 and f32 at the
               serving path's full width (H=32, H_kv=8, D=128, P=16), on
               strided per-layer views of a page pool as the engine
               passes them, decode also at 8 sequences of 4096 tokens
               (there also held to a share of the output's scale) and
               twice (two calls must give the same bits), f32 decode
               within 1e-5, prefill also at the speculative verify
               window (8 sequences x k+1 = 5 rows, n_tok 1-5), and both
               at the MoE archs' layouts in both dtypes (H 32 / H_kv 4
               and H 16 / H_kv 16, D 128); the copy
               engine bit for bit on random bits
               (NaNs included) in f32/bf16/int8/int32 at the ring chunk
               of a 64 MiB-per-PE psum (8 PEs x 8 MiB), ragged and
               misaligned; the combine kernel bit for bit for
               sum/prod/max/min in f32/bf16/int32 with NaNs at the same
               shape, misaligned, at a ragged length and below one
               vector; and the pallas backend equal to posh in bf16;
  4. serve   — ``repro_torch.launch.serve.build_engine`` on full-width
               qwen3-8b (36 layers, bf16 weights drawn on the card from
               a seed), a seeded trace of 8 requests; the paged-attention
               launch counters, zeroed just before, must equal n_layers x
               the prefill and decode steps of the run; the same trace
               again with ``torch.profiler`` on two windows of ticks for
               where the device time goes; then, on the same weights
               (only pools are new): speculative decoding, k = 4, of the
               same trace with four proposers (n-gram, replay of the
               n-gram run's streams, a fixed [0, 1, 2, 3], a draft model
               with the target's own weights and config), whose streams
               must be identical and replay must accept everything (the
               non-spec run's streams are compared, every diverging
               stream's first divergence printed with its top-2 margin;
               the draft must accept everything where none diverges),
               whose
               prefill body must launch n_layers x (prefill steps +
               verify ticks + the draft's prefill steps) and decode body
               n_layers x the draft's decode steps, with ten profiled
               verify ticks of the n-gram engine; a 200-token prompt
               served twice with ``prefix_keep``, the second a prefix
               hit through 12 migrated pages (12 put_nbi, one quiet) with
               the first's stream; an SLO run (``--slo 0.5+0.25``,
               TTFT deadlines, a pool that forces eviction, a shed) whose
               served streams must equal an FCFS run's and whose
               interactive attainment must beat FCFS's; and
               disaggregated serving (only pools and mailboxes new): the
               trace with its outputs cut to 16-32 (``TICK_TRACE``) on
               clock "tick" colocated (the yardstick of phases 8 and 10),
               then on 1+1 prefill+decode cells under the host and the
               AMO router, 2+2 under both, and 2+2 host with k = 4
               n-gram, each run gated (zero
               quiets on the handoff, router and pool queues, signals =
               pages, waits = tickets, every pool whole after the run,
               launches n_layers x the cells' steps), 1+1 amo's streams
               equal to 1+1 host's, each 2+2 peak below twice the
               weights, each run's divergences from colocated printed
               with their top-2 margins, and ten profiled 2+2 ticks that
               must issue a ticket and show no host<->device memcpy of a
               page row's size; then, that engine freed,
               qwen3-8b at full width in f32 (the reference's serving
               dtype; f32 weights drawn on the card): the first prefill
               chunk's and first decode step's logits through the
               kernels must agree with the plain versions' within 1e-3 x
               max |logit|, and a seeded trace (the same 8 requests,
               outputs cut to 16-32 tokens) must launch the f32 bodies
               n_layers x its prefill and decode steps and the bf16
               bodies never (tok/s, wall time, peak memory printed), and
               the same trace with speculation (k = 4; n-gram, replay of
               the non-spec streams, a draft model with the target's own
               weights) must give the same streams through the f32
               prefill body, replay and draft accepting everything, and
               the f32 trace on 1+1 and 2+2 host cells (the same gates)
               must give the f32 colocated streams, a divergence passing
               only at a top-2 margin below 1e-5 x |top logit|, the 2+2
               peak below twice the f32 weights;
               then, that engine freed, the MoE stage: qwen3-moe-30b-a3b
               at full width in bf16 (48 layers, 128 experts top-8,
               30.5 B parameters drawn on the card from seed 0) serves
               the serve trace's 8 requests, outputs cut to 8-16
               (``MOE_TRACE``), twice (clock "tick", the same
               streams both times), launches n_layers x steps, ten
               profiled decode-only ticks beside the decode step's
               weight-read bound, and the routing-aware first-step
               comparison of the kernels against the plain versions
               (flips printed, not gated in bf16); then qwen2-moe-a2.7b
               at full width in f32 (60 experts padded to 64, top-4, a
               shared expert, 15.2 B parameters; 256 pages): the same
               comparison gated (rows no routing flip reaches within
               1e-3 x max |logit|, every first flip a near-tie), and the
               f32 trace, launches n_layers x steps; then the smoke
               configs of qwen3-8b, qwen3-moe-30b-a3b and qwen2-moe-a2.7b
               in f32 on the card must give the same greedy streams with
               the kernels as with the plain versions, without and with
               speculation and after prefix resumes, each kernel run
               launching n_layers x its steps;
  5. comm    — ``repro_torch.launch.comm_bench`` on the card: one team
               of 8 PEs, every collective under each algorithm, then the
               main path: psum, all_gather, psum_scatter, all_to_all and
               pbroadcast through communicators of the xla/posh/pallas
               backends at 256 B to 64 MiB per PE, then the copy-variant
               sweep.  The bench fails unless pallas equals posh bit for
               bit, posh matches xla, and each pallas call launched the
               copy kernel once per round at or above the stock
               threshold.  The launch counters are zeroed just before the
               main path and read just after: the copy kernel's count
               must equal the staged rounds of every call made there,
               and the combine kernel, which no collective calls, must
               show none; the copy launches by staged payload (bytes,
               dtype, variant) must add up to the count.  One line per
               op: us/call and GB/s over ``COMM_REPS`` timed calls a
               cell after 2 warm-ups; then 10 psums per backend at 64 KiB
               and 64 MiB per PE under the profiler (device busy share,
               kernels by kind).
               ``--comm-out FILE`` writes the bench dict there;
  6. train   — ``repro_torch.launch.train.build_trainer`` on full-width
               gemma-2b (18 layers, f32 parameters and compute, AdamW,
               weights drawn on the card from a seed), sequences of
               4096 tokens, global batch 8 in 8 microbatches, 1 step:
               its loss, seconds, tokens/s and peak memory; the
               flash launch counter, zeroed just before, must equal the
               count predicted in PERF.md (18 layers x 8 microbatches x
               1 step x 2, the recompute under remat included); then
               gemma-2b-smoke and
               qwen3-8b-smoke in f32 on the card must give the same
               3-step losses with the flash kernel as with the plain
               forward;
  7. timing  — each kernel, its plain version, a library yardstick the
               port never calls (``scaled_dot_product_attention`` on
               pre-gathered K/V, or causal with GQA for the flash kernel;
               ``x.clone()``; ``torch.add``) and its bound, with CUDA
               events, the L2 flushed before each launch, at the
               phase-3 shapes (the flash kernel at the training shape, in
               f32 as the trainer runs it and in bf16; paged decode and
               prefill in bf16, the port's default serving dtype, and in
               f32 beside it; decode in both dtypes also at 8 sequences
               of 4096 tokens, SDPA on the gathered K/V its yardstick;
               prefill also at the verify window; decode and prefill at
               the MoE archs' layouts in their serving dtypes; the copy
               engine and ``clone``
               also at the staged payloads 8 x 64 KiB and 8 x 1 MiB, and
               at every payload the comm phase staged, summed as launches
               x time, each payload's times printed); each row with its
               achieved TFLOP/s and GB/s and
               its share of the bound (bound ms / kernel ms);
  8. hot-swap — weight hot-swap (``ckpt.hotswap``) on full-width
               qwen3-8b in bf16 through the paged kernels: on the serve
               stage's weights (``build_engine``, seed 0), generation 1
               drawn from seed 1000 is streamed in 1 MiB rows, 512 a
               tick (31 batches), while ``TICK_TRACE`` runs on clock
               "tick", then a second trace (outputs cut to 16-32) runs
               on the new weights;
               colocated and on 1+1 host cells at 36 layers, on 2+2 host
               cells at 2 (four stages of the full model would not fit).
               Each run is gated: one flip, after the first tick, every
               cell switched on it, zero fences and quiets on the swap
               and handoff queues, ``swap_bytes`` the packed payload
               (pinned on the host), every token before the flip equal
               to the old weights' stream, launches n_layers x steps,
               the peak under its gate; the post-flip streams must equal
               a cold engine's on the new weights bit for bit.  Each
               run's swap ticks, tick wall with a batch in flight, without
               one and at the flip, and peak are printed;
  9. ckpt    — checkpoint/restart of the trainer (``ckpt``, ``ft``):
               gemma-2b at its published width cut to 2 of 18 layers,
               f32, 4 rows of 4096 tokens a step, 3 steps uninterrupted; then 2 steps through
               ``ft.run_with_restarts`` with a checkpoint every step
               and a failure injected at step 1, restored from disk;
               then ``launch.train --resume`` to step 3.  The resumed
               losses must equal the uninterrupted run's within the gap
               of its repeat (printed); bytes written, snapshot, write,
               load + sha256 seconds and the free disk are printed, the
               flash launches checked, the directory deleted;
 10. tp      — tensor-parallel serving on the stacked team: full-width
               qwen3-8b in bf16 at TP 4, one replica (weights drawn from
               seed 0 as phase 4 draws them, stacked by
               ``weights.shard_for_tp``), ``TICK_TRACE`` on clock
               "tick" under the xla, posh and pallas backends, each run
               gated: paged launches n_layers x steps (one launch a layer
               for all 4 PEs), 73 psums and one top-k merge a step, the
               copy kernel exactly the staged rounds of the pallas run's
               calls (xla and posh none), the peak under 1.25 x phase
               4's tp = 1 colocated run's; pallas == posh bit for bit,
               and xla vs posh and TP 4 vs phase 4's tp = 1 streams by
               the near-tie rule (``near_tie_gate``): each first
               divergence printed with its top-2 margin, passing at one
               bf16 ulp, or where both computations, run over the same
               history, give logits at most 5% of |top| apart and the
               diverging token lies within that gap of the top; that 5%
               checked against the gaps of the sound computations and of
               planted faults (one psum dropped) on fixed cases; the
               paged kernels held to the plain versions on the TP step's
               own decode, prefill and verify inputs, every PE's page 0
               read by no live row; tok/s, wall, peak, psum calls and
               the psum ms a step modelled from isolated timings; then
               spec k = 4 (n-gram) under posh, its streams held to the
               posh run's by the rule (the verify rows' computation
               replayed as one-row windows); then TP 2 under posh, held
               to tp = 1 by the rule, and 2+2 host cells of TP 2 on one
               stacked weights dict, phase 4's disagg gates, their
               streams held to the colocated TP 2 run's by the rule;
               then the smoke qwen3-8b in f32 at TP 2 and 4 with two
               replicas, every backend: kernel streams == plain streams
               without and with speculation and after a prefix resume
               on replica 1;
 11. moe tp  — MoE serving at tp > 1 (expert parallelism): full-width
               qwen3-moe-30b-a3b in bf16 at TP 4, one replica, posh,
               the einsum dispatch (weights drawn from seed 0 as phase 4
               draws them, the experts stacked as views), phase 4's
               trace on clock "tick" twice (the same streams), each run
               gated: paged launches n_layers x steps, 97 psums and one
               top-k merge a step, the peak under 1.25 x phase 4's tp = 1
               MoE peak and under 80 GB; the paged kernels held to the
               plain versions on the run's own decode and prefill inputs
               and timed there (the per-PE layout); the second run
               recorded (``MoeRecorder``) and its divergences from phase
               4's recorded tp = 1 run printed with their top-2 margins
               and the first routing flip, the first step's routing flips
               printed (bf16: not gated); then pallas on the trace with
               its outputs cut, == posh on the same cut trace bit for
               bit, the copy launches the staged rounds; then
               qwen2-moe-a2.7b in f32 at TP 4 (posh) under einsum and then
               alltoall (2 all_to_all a layer, no routed psum) on phase
               4's f32 trace: the first step's logits within 1e-3 x max
               |logit| of tp = 1 on rows no routing flip reaches, every
               first flip a near-tie, and every stream equal to tp = 1's
               but at a near-tie (``moe_streams_verdict``: a top-2 margin
               below 1e-5 x |top logit|, or after a first routing flip
               whose gate gap is below 1e-5), alltoall held to einsum the
               same way, the kernels held to the plain versions on the
               einsum run's inputs and timed there; then the smoke MoE
               configs in f32 at TP 2 and 4 with two replicas, every
               backend and dispatch: kernel streams == plain streams,
               with speculation (k = 2) too, and 2+2 cells of TP 2;
 12. dp      — data-parallel training on the stacked team
               (``build_trainer(dp_size=2, ...)``): (a) full-width
               gemma-2b (18 layers, f32, seed 0) at DP 2 under pallas
               with 4 MiB buckets, overlapped, one step of phase 6's
               global batch (4 rows a replica in 4 microbatches): the
               loss and grad norm within 1e-5 / 1e-4 of phase 6's dp = 1
               step, flash launches 2 x 18 x 4 x 2, copy launches the
               staged rounds of ``dp_comm``'s calls, every reduced row
               row 0's bits (``DpProbe``); its seconds, tok/s, the
               reduction's and the drain's share of the step (CUDA
               events) and the peaks beside the PERF.md predictions
               printed; (b) at 2 of 18 layers, a row a replica, 2 steps
               a run: overlapped == blocking per-leaf and with 4 MiB
               buckets, pallas == posh bit for bit, xla within 1e-5 of
               posh and bf16 compression within 1e-3 of f32 on the
               loss, ZeRO-1's chunks ``(2, c)`` and ``state_to_tree``'s
               ``(2 c,)`` leaves and its repeat's losses the same, each
               run's launches counted;
 13. a10     — A10's first part: the RWKV and Mamba-hybrid families,
               minitron-4b, h2o-danube-3-4b and the contiguous-cache
               decode.  (d) the flash kernel against its plain version
               at the new paths' shapes, T = S = 4608 (past the 4096
               window): H 32 / H_kv 8 at D 120 windowed (danube), 32 /
               32 at D 112 windowed (zamba2's shared block), 24 / 8 at
               D 128 causal (minitron, group 3), in f32 and bf16 on the
               output and lse (phase 3's tolerances), the autograd path
               at D 120 with a window, and each shape timed in its
               path's dtype beside SDPA with a boolean window mask and
               the bound by operations over the pairs the window leaves;
               (a) rwkv6-3b's published config in f32, all 32 layers,
               one ``build_trainer`` step of 2 x 512 tokens (loss within
               1.0 of ln(65536)), then on the same weights in bf16 16
               prompt tokens and 16 greedy ones through ``decode_step``,
               and at 2 layers in f32 ``decode_step``'s tokens along a
               64-token prompt == the forward's argmax (a difference only at a
               top-2 margin below 1e-5 x |top|); (b) zamba2-7b's
               published config in bf16, all 81 layers: ``lm.prefill``
               of 4160 tokens (13 flash launches, the bf16 body), then
               8 ``decode_step`` tokens from the prefill's pick,
               position 0 held to the forward's argmax by the near-tie
               rule, the later positions' agreement printed (the
               reference threads one shared cache through the 13
               applications), then one f32 step at 12 layers (2 whole
               groups); (c) danube (t = 4608) and minitron one f32 step
               at 4 layers each, danube's published config in bf16
               decoding 16 + 16 tokens; the flash launches of (a)-(c)
               equal to the count the layers, microbatches and remat
               predict; every peak printed, each model freed before the
               next;
 14. xattn   — A10 items 1-2: the cross-attention families.  (d) the
               flash kernel against its plain version, non-causal, at
               whisper's encoder (B 4, H 8 / 8, T = S = 1500, D 64),
               whisper's cross attention (T 448 over S 1500) and the
               vlm's (B 2, H 64 / 8, T 1024 over S 1601, D 128), f32 and
               bf16, output and lse (phase 3's tolerances), the autograd
               path at whisper's cross shape, each shape timed in its
               path's dtype beside SDPA (non-causal, GQA) and the bound
               by operations (4 T S D a head); (a) whisper-base's
               published config in f32, 6 + 6 layers, one
               ``make_train_step`` step of 8 rows (1500 seeded frames,
               448 + 1 tokens) in 2 microbatches (loss within 1.0 of
               ln(51865), flash launches == 18 x 2 x 2); (b) on those
               weights, f32 and bf16: ``encode`` of 4 rows,
               ``encoder_cross_kv``, 64 greedy ``decode_step`` tokens,
               each position held to the teacher-forced
               ``decode_train``'s argmax by the bf16 near-tie rule (the
               caches are bf16 in both dtypes); (c) llama-3.2-vision-90b
               at published width in bf16, 2 of its 20 groups (10.7 B
               parameters), both gates of each group non-zero:
               ``prefill`` of 2 x 1024 tokens against 1601 seeded image
               rows, 32 ``decode_step`` tokens with ``img_kv``, held to
               ``forward``'s argmax by the same rule; the smoke vlm's
               loss and gradients with the kernel == the plain forward's;
               every path's flash launches == the predicted count.
 15. tp train — A10 item 3 and item 4's head layout: MoE training and
               TP training.  (d) the flash kernel against its plain
               version in f32 at the layouts these paths launch it
               with (qwen3-moe H 32 / 4, qwen2-moe 16 / 16, D 128, T =
               S = 2048; qwen3-8b at TP 4, every PE's 8 / 2 heads in one
               launch, B = 4 PEs x 2 rows); (a) qwen3-moe-30b-a3b and
               qwen2-moe-a2.7b at published width, 2 layers, f32 +
               AdamW (``build_trainer``): ``loss_and_grad`` of 4 x 2048
               tokens with the kernel forward against the plain forward
               (loss 1e-5, every leaf's gradient 1e-4 of its largest
               where no routing decision differs: the routing of both
               runs recorded and compared row by row, the first
               difference a top-k flip at a near-tie; the padded
               experts' gradients exactly 0), then one step in 2
               microbatches at the published capacity factor 1.25: the
               pairs dropped a layer (> 0), every routing call's kept
               pairs == a host recount in token-major order, flash
               launches == 2 x 2 + 2 x 2 x 2; (b) qwen3-8b and
               qwen3-moe-30b-a3b (einsum) at 2 layers, f32: 2 x 2048
               tokens through ``loss_and_grad`` at TP 4 (posh, the
               stacked team, sequence parallelism, the TP layout)
               against tp = 1 on the same weights (loss rtol 2e-5,
               gradients 5e-4 of each leaf's largest, the MoE's
               routing rule of (a)); qwen2-moe-a2.7b (alltoall, each
               PE routing its own sequence shard) at TP 4 with the
               kernel forward against the plain forward (the gate and
               routing rule of (a), every PE's routing recorded);
               seconds, peaks, collectives a step by kind, 4 flash
               launches a kernel run, none a plain one.
 16. tp families — A10 item 4's remainder: TP training of every family
               left and the contiguous-cache decode at tp > 1, each
               model's weights drawn once for its tp = 1 and TP runs,
               training held to tp = 1 by phase 15's (b) tolerances
               (rwkv6's and zamba2's gradients, TP's and tp = 1's, to
               an f64 run of the step within 5e-3 of a leaf's largest:
               their f32 runs sit up to 2.5e-3 from exact) and each
               decode stream by the near-tie rule (rwkv6's all-f32
               state: the TP pick within the two computations' largest
               logit gap of tp = 1's top and that gap within 1e-5 of
               it; a decode reading bf16 caches back: phase 10's).  (a) minitron-4b, f32, 2 of 32 layers, TP
               16 under posh (24 heads: the ctx attention layout): 2 x
               2048 tokens through ``loss_and_grad``, one flash launch a
               layer for all 16 PEs (B 32, T 128 a PE, S 2048, H 24 / 8,
               D 128, each PE's rows at its own causal offset), the
               kernel == plain on the step's own captured inputs; 64
               prompt tokens then 32 greedy through the decode at TP 16
               (the bf16 cache sequence-sharded, 6 rows a PE); (b)
               rwkv6-3b, f32, 2 layers, TP 4 posh (12 of the 48 padded
               heads a PE): a step, 8 + 16 decoded tokens; (c)
               zamba2-7b, f32, 12 of 81 layers (2 applications of the
               shared block, 8 heads of 112 a PE in one flash launch),
               TP 4 xla: a step, 8 + 8 decoded tokens; (d) whisper-base,
               f32, 6 + 6 layers, the vocab padded to 16: 2 x (1500
               frames, 448 + 1 tokens) at TP 4 (head layout) and TP 16
               (ctx layout, 28 rows a PE, the encoder whole on every
               PE), 4 + 32 decoded tokens at TP 4; (e)
               llama-3.2-vision-90b, bf16, 1 of 20 groups (4 dense + 1
               cross layer), TP 4 posh, gates non-zero: prefill 1 x 1024
               tokens against 1601 image rows, then 16 tokens through
               the decode from its pick.  Then the flash kernel timed at
               (a)'s captured call and at phase 15's layouts (qwen3-moe
               H 32 / 4, qwen2-moe 16 / 16, qwen3-8b TP 4's stacked 8 /
               2; T = S = 2048): kernel, plain, SDPA with the boolean
               mask of every row's causal offset, and the bound
               (operations over the visible pairs, f32).  The copy
               kernel launches 0 times: posh and xla move the stacked
               team's collectives with tensor operations.

 17. posh-micro, checker, dry run — the tooling slice.  (a) posh-micro
               at its full config, the paper's Tables 1-2 experiment
               (``examples/torch/shmem_pingpong.py``'s sweep) on the
               stacked 8-PE team: 10 sizes (16 .. 4 Mi elements a PE) x
               f32 / bf16 / int32 x put, get, 8 put_nbi + one quiet and
               a local copy, then the K = 8 x 16384 pipeline (nbi vs
               blocking), each under the default stager and the copy
               kernel's, 3 warm-ups + 20 repeats a cell; gated: every
               output == its input rolled by the round's pairs bit for
               bit, the copy stager's == the default's, the copy
               kernel's launches == the staged rounds of every call; it
               prints the table (us a call, per-PE GB/s, put / get over
               the copy) with the card.  (b) the port's shmemcheck armed
               over a smoke disagg 1 + 1 amo run with a hot-swap flip on
               CUDA tensors: 0 findings, signal and atomic words seen, one
               flip, a handoff; a deliberately racy put pair gives one
               ww-race.  (c) ``launch.dryrun`` of phase 6's step on the
               meta device, in a process of its own started after
               phase 5 (it sees no card; ~30 s beside phase 6's start): its
               FLOPs, bytes and predicted peak beside phase 6's measured
               ``max_memory_allocated``; gated: the peak within 20%, the
               flash kernel's meta calls == phase 6's launches.

Phase 3 also holds the flash-attention kernel against its plain version
in f32 (1e-4) and bf16 (2e-2), on the output and the log-sum-exp, at the
training path's full width (B=1, H=8, H_kv=1, T=S=4096, D=256, causal),
at D=128 with a group of 4, at a sliding window of 96 over a ragged
T=S=1000 and without the causal mask; and the autograd path (kernel
forward, plain backward) against the all-plain path on the grads.

``launches`` in the kernels line is each kernel's count from its main
path (the bf16 serve run for the paged-attention kernels, with
``launches_f32`` from the f32 serve run, ``launches_spec`` summed
over the speculative runs, ``launches_disagg`` / ``launches_disagg_f32``
summed over the bf16 / f32 disaggregated runs, ``launches_moe`` from the bf16
qwen3-moe-30b-a3b run and ``launches_moe_f32`` from the f32
qwen2-moe-a2.7b run), the communicator calls for
the copy engine, the gemma-2b training steps for the flash kernel; 0
for ``combine_blocked``, which is reached only through ``ops.combine``;
``launches_swap`` on the paged kernels from the hot-swap runs, and
``launches_ckpt`` on the flash kernel from the checkpoint stage's runs;
``launches_tp`` from phase 10's runs: the paged kernels', by dtype in
``launches_tp_by_dtype``, and the copy kernel's; ``launches_moe_tp``
likewise from phase 11's; ``launches_dp`` on the flash and copy
kernels from phase 12's runs; ``launches_a10`` on the flash kernel from
phase 13's runs, with ``max_abs_err_a10`` its errors at the new shapes
and ``a10_shapes`` their timing; ``launches_xattn``, ``max_abs_err_xattn``
and ``xattn_shapes`` likewise from phase 14's; ``launches_train_moe`` /
``launches_train_tp`` from phase 15's MoE and TP training runs, with
``max_abs_err_train`` the kernel's errors at their layouts;
``launches_tp_families`` from phase 16's TP runs, with
``tp_families_shapes`` the timing at its layouts and
``max_abs_err_tp_families`` the kernel's errors there; on the copy
kernel, phase 16's launches, 0; ``launches_posh_micro`` on the copy
kernel from phase 17's sweep, with ``checker`` (b)'s result, and
``dryrun_phase6`` on the flash kernel, (c)'s prediction beside phase 6).
``max_abs_err_tp`` / ``max_abs_err_moe_tp``
on the paged kernels is their largest |kernel - plain| on phase 10's /
11's captured TP inputs, and ``moe_tp_layouts`` their timing at phase
11's per-PE layouts.
It prints a ``{"kernels": [...]}`` line, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without the repository's ``src/`` beside it, it exits
non-zero and prints no result.  It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import atexit
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import types
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# full width of the main path (qwen3-8b): heads, KV heads, head dim,
# page tokens; the parity/timing batch
H, HKV, D, P = 32, 8, 128, 16
B = 8
# the MoE archs' attention layouts (query heads, KV heads; D = 128, P =
# 16 as above): qwen3-moe-30b-a3b (GQA group 8) served in bf16,
# qwen2-moe-a2.7b (group 1) in f32
MOE_HEADS = {"qwen3-moe-30b-a3b": ((32, 4), torch.bfloat16),
             "qwen2-moe-a2.7b": ((16, 16), torch.float32)}
DECODE_LENS = [0, 1, 9, 16, 100, 256, 512, 777]    # 0, mid-page, full pages
WINDOW = 64
WIN_START = [0, 5, 16, 100, 250, 37, 448, 0]       # mid-page starts
WIN_NTOK = [64, 64, 30, 64, 1, 64, 64, 0]          # padded, inactive rows
# the speculative verify window: k+1 = 5 rows per sequence (the pending
# token and 4 drafts; 20 score rows at the GQA group of 4), n_tok 1..5,
# starts mid-page as decode positions are
SPEC_K = 4
VERIFY_START = [8, 99, 300, 15, 611, 47, 200, 770]
VERIFY_NTOK = [5, 1, 3, 5, 2, 4, 5, 5]
N_SLOTS = 64                                       # 1024 tokens of table
# the long-context decode shape: the same heads, every sequence 4096
# tokens (qwen3-8b's max_seq in the serving config's table)
LONG_LEN, LONG_SLOTS = 4096, 256
# tolerances against the plain version: f32 differs only by summation
# order (online vs dense softmax); bf16 inputs are the same bits on both
# sides and both accumulate in f32, so the gap is the final bf16
# rounding of outputs |o| < 4 (one bf16 ulp there is <= 1.6e-2)
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# decode in f32 is held closer: its sums are over one token's head dim
# and one partition's tokens, merged in partition order
DECODE_TOL = {**TOL, torch.float32: 1e-5}
# at 4096 tokens the outputs shrink to |o| ~ 0.1 at most, under TOL; there
# max |kernel - plain| is also held to this share of max |plain|, so a
# merge that loses one of a sequence's 32 partitions fails
SCALE_TOL = 2e-2
# the comm path: 8 PEs; the ring chunk of a 64 MiB-per-PE psum, 8 x 8 MiB
# of f32 (the path also stages larger payloads, to 8 x 64 MiB, each timed
# in the path's sum); and two smaller staged payloads of the path, 8 x 64
# KiB and 8 x 1 MiB
N_PE = 8
COMM_REPS = 4      # timed calls a comm cell, after 1 checked + 2 warm-up
STAGED = (N_PE, 2 << 20)
STAGED_SMALL = [(N_PE, 16 << 10), (N_PE, 256 << 10)]

# the training path's attention: gemma-2b, one sequence of 4096 tokens
FLASH_FULL = dict(b=1, h=8, hkv=1, t=4096, s=4096, d=256)
# the other parity shapes: D=128 with a GQA group of 4; a sliding window
# of 96 over a ragged T=S=1000; no causal mask
FLASH_CASES = [(FLASH_FULL, dict(causal=True)),
               (dict(b=2, h=8, hkv=2, t=512, s=512, d=128), dict(causal=True)),
               (dict(b=1, h=4, hkv=1, t=1000, s=1000, d=256),
                dict(causal=True, window=96)),
               (dict(b=1, h=4, hkv=4, t=777, s=777, d=128),
                dict(causal=False))]
TRAIN = dict(arch="gemma-2b", global_batch=8, microbatches=8, steps=1)

SERVE_TRACE = dict(n_requests=8, rate=8.0, seed=0,
                   prompt_short=(64, 257), prompt_long=(257, 513),
                   long_frac=0.25, out_short=(32, 65), out_long=(32, 65))
# the f32 serve run (the reference's serving dtype): the same 8 requests
# with their outputs cut to 16-32 tokens, so the phase stays near 30 s
SERVE_TRACE_F32 = {**SERVE_TRACE, "out_short": (16, 33), "out_long": (16, 33)}
# an engine's warm-up: two requests of the trace's prompts cut to 4
# outputs, so every shape of a run (64-row windows, 8-row decode steps,
# their psum payloads) is seen once before the clock starts
WARMUP_TRACE = {**SERVE_TRACE, "n_requests": 2, "seed": 99,
                "out_short": (4, 5), "out_long": (4, 5)}
# first-step logits of the kernel path against the plain path, as a share
# of max |logit| (f32: the two differ by summation order only)
LOGIT_TOL = 1e-3
# the prefix-migration run: one 200-token prompt (three 64-token chunks
# plus 8: 12 full pages of 16) served twice, the second a prefix hit
PREFIX_PROMPT, PREFIX_NEW = 200, 16
# the SLO run (``--slo 0.5+0.25`` with TTFT deadlines, clock="tick"): 12
# requests, prompts 64-256 tokens, 8-16 out, on a pool of 48 pages.  The
# 72-token tick budget prefills about one 64-token chunk a tick, so an
# interactive deadline of 10 ticks (a 256-token prompt needs 4) is met
# by some requests and not all, and priority admission shows in its
# attainment; the lone best-effort request waits past its 20 ticks and
# is shed, and the small pool forces one eviction.  The scheduler alone
# (``ServeEngine`` on the smoke model with the same trace and geometry:
# scheduling does not depend on the tokens) shows FCFS 3 of 7
# interactive requests in time and SLO 5 of 7, one eviction, one shed.
SLO_TRACE = dict(n_requests=12, rate=8.0, seed=0, prompt_short=(64, 129),
                 prompt_long=(129, 257), long_frac=0.25, out_short=(8, 17),
                 out_long=(8, 17), interactive_frac=0.5, batch_frac=0.25)
SLO_TTFT = dict(interactive=10.0, batch=20.0, best_effort=20.0)
SLO_PAGES = 48
# the disaggregation stage: TICK_TRACE on clock "tick", colocated,
# then on these topologies ((prefill cells, decode cells), router, spec
# k) over the same weights, only pools and mailboxes new; in f32 the f32
# trace on 1+1 and 2+2 host cells
DISAGG_RUNS = [((1, 1), "host", 0), ((1, 1), "amo", 0), ((2, 2), "host", 0),
               ((2, 2), "amo", 0), ((2, 2), "host", SPEC_K)]
# the tick-clock runs of full-width qwen3-8b in bf16 (the disagg
# topologies, the hot swap, phase 10's TP runs) serve the serve trace's
# 8 requests with outputs cut to 16-32, as the f32 runs do; phase 4's
# colocated run of it is their yardstick
TICK_TRACE = SERVE_TRACE_F32
DISAGG_RUNS_F32 = [((1, 1), "host", 0), ((2, 2), "host", 0)]
# an f32 disagg stream may leave the colocated f32 stream only at a
# near-tie: a top-2 margin at its first divergence below this share of
# |top logit| (the f32 kernels' summation-order gap, phase 3)
F32_NEAR_TIE = 1e-5
DISAGG_PROFILE_TICKS = 10
# the MoE stage: qwen3-moe-30b-a3b at full width in bf16 (61.1 GB of
# weights, 512 pages of 1.57 MB) and qwen2-moe-a2.7b in f32, the
# reference's serving dtype (60.6 GB of weights; 256 pages of 6.3 MB,
# 1.6 GB: 512 would take ~64 GB with the weights and leave too little
# of the 80 for the plain path's comparison and the step's activations)
MOE_BF16, MOE_F32 = "qwen3-moe-30b-a3b", "qwen2-moe-a2.7b"
MOE_F32_PAGES = 256
# both MoE runs serve the serve trace's 8 requests with their outputs
# cut to 12-24 (16-32, the f32 runs' trace, before phase 15 was added):
# phase 11 serves it again at TP 4, three times, and captures its
# decode inputs at step MOE_PICK_DECODE (TP_PICK_DECODE, 20, before the
# cut); the cut pays for phase 15 with a margin for the host's spread
MOE_TRACE = {**SERVE_TRACE, "out_short": (12, 25), "out_long": (12, 25)}
MOE_PICK_DECODE = 15
# The routing comparison calls a row's routing a near-tie when the gap
# between its k-th and (k+1)-th gate, as a share of the k-th, is below
# this.  f32: the kernels differ from the plain versions by summation
# order (1e-5 at most, phase 3), which moves a router logit of size ~1
# by ~1e-5 after a few dozen layers; 1e-3 is a hundred times that.
# bf16: the router's logits are rounded to bf16 (2^-7 apart for logits
# in [1, 2)) and the kernels' outputs differ from the plain versions by
# one bf16 ulp, so gates that are eight ulps apart (a share of 2^-4)
# can swap; printed, not gated.
MOE_TIE = {torch.float32: 1e-3, torch.bfloat16: 2.0 ** -4}
# the hot-swap stage (full-width qwen3-8b in bf16 on the serve stage's
# weights, seed 0): generation 1 drawn from seed + 1000, as the serve
# CLI's --hot-swap draws it, streamed in 1 MiB rows, 512 a tick (512 MiB:
# the 16.38 GB land in 31 batches; the CLI's default, 4 rows of 16 KiB,
# would take ~250,000 ticks); TICK_TRACE on clock "tick" with the
# stream in flight, then a second trace after the flip
SWAP = dict(row_bytes=1 << 20, chunk_rows=512)
SWAP_SEED = 1000
SWAP_TRACE_POST = {**SERVE_TRACE_F32, "seed": 1}
# peak-memory gates (GB), from the PERF.md prediction: the old weights,
# the new draw (alive while it is packed), one stage a PE, the pools and
# the mailbox; 2+2 runs at 2 of qwen3-8b's 36 layers (4 stages of the
# full model would not fit in 80 GB)
SWAP_PEAK_GB = {(0, 0): 55.0, (1, 1): 74.0, (2, 2): 25.0}
SWAP_2P2_LAYERS = 2
# the checkpoint stage: gemma-2b at its published width cut to 2 of its
# 18 layers (the full f32 state is ~30 GB on disk a checkpoint; two
# layers, so the restack of the per-layer lists is exercised), phase 6's
# rows at half its batch (4 rows of 4096 tokens, a row a microbatch);
# 3 steps uninterrupted, then 2 steps through run_with_restarts with a
# checkpoint every step and a failure injected at step 1, then
# launch.train --resume to step 3 on that directory
CKPT = dict(arch="gemma-2b", layers=2, global_batch=4, microbatches=4,
            steps=3, restart_steps=2, every=1, fail_at=1)
CKPT_DIR = os.path.join(ROOT, "build", "chip_smoke_ckpt")
# the data-parallel stage: gemma-2b at its published width, f32, DP 2 on
# the stacked team.  (a) full depth, one step of phase 6's global batch
# (8 rows: 4 a replica in 4 microbatches, one row in flight as in phase
# 6) under pallas, 4 MiB buckets, overlapped; (b) at phase 9's depth cut
# (2 of 18 layers), a global batch of 2 (a row a replica), 2 steps a
# run: each schedule under pallas, then posh and xla per-leaf, bf16
# compression, ZeRO-1 twice
DP = dict(arch="gemma-2b", dp=2, global_batch=8, microbatches=4,
          backend="pallas", bucket_bytes=4 << 20, cut_layers=2,
          cut_batch=2, cut_steps=2)
# the PERF.md predictions (GB): params 10.03 + stacked grads 20.06 + m/v
# 20.06 + ~13.3 of activations at the backward's end; at the drain the
# largest bucket's psum temporaries (~4 x its 4.83 GB) stand where the
# activations were (each sum is written back into the rows)
DP_PEAK_PRED = dict(backward=63.5, drain=69.0)
# the 2-layer runs: (name, backend, step options)
DP_CUT_RUNS = (
    ("leaf", "pallas", {}),
    ("overlap_leaf", "pallas", {"overlap_grad_sync": True}),
    ("bucket", "pallas", {"bucket_bytes": 4 << 20}),
    ("overlap_bucket", "pallas", {"bucket_bytes": 4 << 20,
                                  "overlap_grad_sync": True}),
    ("posh_leaf", "posh", {}),
    ("xla_leaf", "xla", {}),
    ("bf16", "pallas", {"compress": "bf16"}),
    ("zero1", "pallas", {"zero": 1}),
    ("zero1_repeat", "pallas", {"zero": 1}))
# the tensor-parallel stage: full-width qwen3-8b in bf16 at TP 4 (one
# replica) under each communicator backend, then spec k = 4 (n-gram)
# under posh, then 2+2 host cells of TP 2 under posh; each TP run's peak
# under TP_PEAK x the tp = 1 colocated run's (phase 4); then the smoke
# config in f32 at TP 2 and 4 with two replicas, kernels against plain
TP_FULL, TP_CELLS = 4, 2
TP_BACKENDS = ("xla", "posh", "pallas")
TP_PEAK = 1.25
TP_SMOKE = (2, 4)
TP_SMOKE_REPLICAS = 2
# a bf16 stream may leave another computation's (another backend's psum
# order, tp = 1's single matmuls) where its token is within the two
# computations' measured logit gap of the top; that gap must stay under
# this share of |top logit|.  Every run also measures the gap on fixed
# cases (TP_GAP_J: output 16 of each request) between the sound
# computations and for planted faults, one psum of every forward
# dropped (``tp_faults``: layer 19's attention psum, layer 36's MLP
# psum), and fails unless this share lies between the two.  On the H100
# (700 W) the sound gaps were 2.18-2.53% of |top| and the faults' 24.6%
# and 10.2%: the cap is their geometric mean, 5%, a factor 2 from each
NEAR_TIE_DELTA = 0.05
TP_GAP_J = 16
# the TP steps whose paged calls (their last layer's) are held against
# the plain versions on their own inputs: decode step 20 and the 64-row
# window of prefill step 0 of the pallas run, the verify window of
# verify step 10 of the spec run
TP_PICK_DECODE, TP_PICK_VERIFY = 20, 10

# phase 13 (A10's first part): the flash kernel at the new paths' shapes,
# T = S = 4608 (past the 4096-token window): h2o-danube-3-4b (H 32 / H_kv
# 8, D 120, window), zamba2-7b's shared block (32 / 32, D 112, window),
# minitron-4b (24 / 8, group 3, D 128, causal); timed in each path's
# dtype (danube and zamba2 prefill run the bf16 body)
A10_SEQ = 4608
A10_FLASH = {"danube": dict(h=32, hkv=8, d=120, window=4096),
             "zamba2": dict(h=32, hkv=32, d=112, window=4096),
             "minitron": dict(h=24, hkv=8, d=128, window=None)}
A10_TIMED = [("danube", torch.float32), ("zamba2", torch.float32),
             ("danube", torch.bfloat16), ("zamba2", torch.bfloat16),
             ("minitron", torch.float32)]
# (a) rwkv6-3b: one f32 step of 2 x 512 tokens, all 32 layers (49 GB of
# state at 16 B a parameter); bf16 decode of 16 + 16 tokens (64 + 32
# before phase 14 was added); at 2 layers f32 decode == the forward's
# argmax along a 64-token prompt
A10_RWKV = dict(arch="rwkv6-3b", rows=2, seq=512, prompt=64, dec_prompt=16,
                new=16, check_layers=2)
# (b) zamba2-7b: bf16 prefill of 4160 tokens, 8 decoded tokens (32 before
# phase 14; position 0 is the gate); one f32 step at 12 of 81 layers (2
# whole groups; the whole model's state would be 6.75 B x 16 B = 108 GB),
# 2 rows of 4096 tokens in 2 microbatches
A10_ZAMBA = dict(arch="zamba2-7b", prompt=4160, new=8, train_layers=12,
                 rows=2, mb=2, seq=4096)
# (c) danube's bf16 decode: 16 prompt tokens, 16 greedy (64 + 32 before
# phase 14)
A10_DANUBE_DECODE = dict(prompt=16, new=16)
# (c) one f32 step each at 4 layers, a row a microbatch
A10_DENSE = [("h2o-danube-3-4b", 4, A10_SEQ), ("minitron-4b", 4, 4096)]
A10_DENSE_ROWS = 2

# phase 14 (A10, items 1-2): the flash kernel at cross attention's shapes
# (non-causal, T != S: whisper's 448 decoder rows over its 1500 encoder
# rows, the vlm's 1024 text rows over 1601 image rows with GQA 8) and at
# whisper's encoder (T = S = 1500), B as the paths run them (a whisper
# microbatch of 4 rows, the vlm's 2-row prefill)
XATTN_FLASH = {
    "whisper_enc": dict(b=4, h=8, hkv=8, t=1500, s=1500, d=64),
    "whisper_cross": dict(b=4, h=8, hkv=8, t=448, s=1500, d=64),
    "vlm_cross": dict(b=2, h=64, hkv=8, t=1024, s=1601, d=128)}
# timed in each path's dtype: whisper trains in f32 and decodes in both
# (its encoder through the kernel), the vlm prefills in bf16
XATTN_TIMED = [("whisper_enc", torch.float32),
               ("whisper_cross", torch.float32),
               ("whisper_enc", torch.bfloat16),
               ("whisper_cross", torch.bfloat16),
               ("vlm_cross", torch.bfloat16)]
# (a) whisper-base f32, 6 + 6 layers: one step of 8 rows (1500 frames,
# 448 + 1 tokens) in 2 microbatches; (b) 4 rows decode 64 tokens
XATTN_WHISPER = dict(rows=8, seq=448, mb=2, dec_rows=4, new=64)
# (c) llama-3.2-vision-90b bf16 at 2 of 20 groups (10.7 B parameters,
# 21.4 GB): prefill 2 x 1024 tokens, 32 decoded; the gates of groups 0
# and 1, which start at zero, set non-zero so the cross layers count
XATTN_VLM = dict(groups=2, rows=2, prompt=1024, new=32)
XATTN_GATES = {"xgate": (0.5, -0.3), "mgate": (-0.7, 0.4)}

# phase 15 (A10 item 3, and item 4's head layout): MoE training and TP
# training.  (d) the flash kernel at the layouts these paths launch it
# with, f32 (training), T = 2048: qwen3-moe (H 32 / 4), qwen2-moe (16 /
# 16) and qwen3-8b at TP 4 (every PE's 8 query / 2 KV heads in one
# launch, the PE axis folded into the batch: B = TP x 2 rows)
T15_SEQ = 2048
T15_FLASH = {"qwen3_moe": dict(b=1, h=32, hkv=4, d=128),
             "qwen2_moe": dict(b=1, h=16, hkv=16, d=128),
             "qwen3_8b_tp4": dict(b=8, h=8, hkv=2, d=128)}
# (a) both MoE configs at published width, 2 layers, f32 + AdamW: one
# step of 4 x 2048 tokens in 2 microbatches at the published capacity
# factor 1.25, where pairs drop (layer 0 routes neighbouring tokens
# alike at init: its attention output, a running mean over the prefix,
# outweighs the embedding); the kernel-vs-plain comparison on the whole
# batch, at the same factor.  Every routing call's kept pairs are
# recounted on the host, token-major, and must equal the card's
T15_MOE = dict(layers=2, rows=4, mb=2)
# (b) TP 4 posh on the stacked team, 2 layers, f32, 2 x 2048 tokens:
# qwen3-8b and qwen3-moe (einsum) held to tp = 1 on the same weights and
# batch: loss rtol 2e-5, each leaf's gradient within 5e-4 of its
# largest (the reference's TP equivalence tolerances); qwen2-moe under
# alltoall, whose routing of each PE's own sequence shard differs from
# tp = 1 under drops by design, held to its own plain run at TP 4 by the
# kernel-vs-plain gate of (a), 1e-5 / 1e-4
T15_TP = dict(tp=4, layers=2, rows=2, backend="posh")
T15_TOL = {"plain": (1e-5, 1e-4), "tp": (2e-5, 5e-4)}
# phase 16: TP training of the families A10 item 4 left, both attention
# layouts, and the contiguous-cache decode at tp > 1, at published width
# with the depth cut; each model's weights drawn once (the vocab padded
# for its largest TP), shared by its tp = 1 and TP runs.  Training and
# decode in f32 (the cache bf16), held to tp = 1 by T15_TOL["tp"] and
# the f32 near-tie rule; the vlm in bf16 by the bf16 rule
T16 = {"minitron": dict(arch="minitron-4b", layers=2, rows=2, seq=2048,
                        tp=16, backend="posh", prompt=64, new=32),
       "rwkv": dict(arch="rwkv6-3b", layers=2, rows=2, seq=512, tp=4,
                    backend="posh", prompt=8, new=16),
       "zamba": dict(arch="zamba2-7b", layers=12, rows=2, seq=1024, tp=4,
                     backend="xla", prompt=8, new=8),
       "whisper": dict(arch="whisper-base", layers=0, rows=2, seq=448,
                       tp=4, tp_ctx=16, backend="xla", prompt=4, new=32),
       "vlm": dict(arch="llama-3.2-vision-90b", layers=5, rows=1,
                   prompt=1024, tp=4, backend="posh", new=16)}
# the flash layouts phase 15 launches, timed here (not timed before)
T16_TIMED = ("qwen3_moe", "qwen2_moe", "qwen3_8b_tp4")
# the recurrent families' f32 gradients at published width sit up to
# ~1e-3 (zamba2-7b, 12 layers) and 2.5e-3 (rwkv6-3b's TP products, bmm
# per PE) of a leaf's largest from an f64 run of the same step, tp = 1's
# f32 run as far in kind (call 4), so TP is held to that f64 run, not to
# tp = 1's f32 run at 5e-4; a lost psum or a wrong shard moves a leaf by
# 10-100% of its largest
T16_F64_TOL = 5e-3


def fail(msg: str) -> None:
    print(f"CHIP_SMOKE_FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------------
# inputs at the main path's shapes
# ----------------------------------------------------------------------
def make_pool(gen, dtype, dev, n_slots=N_SLOTS, hkv=HKV):
    """A (n_pages, 2, 2, P, H_kv, D) pool; the kernels get the strided
    per-layer views pool[:, 0, 1] / pool[:, 1, 1], as the engine passes
    pool[:, 0|1, li].  Page 0 (the null page) holds noise too."""
    n_pages = B * n_slots + 1
    pool = torch.randn((n_pages, 2, 2, P, hkv, D), generator=gen,
                       device=dev).to(dtype)
    bt = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    return pool, bt.reshape(B, n_slots).to(torch.int32)


def null_pad(bt, tokens):
    """Null-pad each row past the pages its tokens need (engine shape)."""
    bt = bt.clone()
    for b, n in enumerate(tokens):
        bt[b, -(-n // P):] = 0
    return bt.contiguous()


def decode_case(dtype, dev, seed=1, n_slots=N_SLOTS, heads=(H, HKV)):
    gen = torch.Generator(device=dev).manual_seed(seed)
    pool, bt = make_pool(gen, dtype, dev, n_slots, heads[1])
    q = torch.randn((B, heads[0], D), generator=gen, device=dev).to(dtype)
    lens = torch.tensor(DECODE_LENS, dtype=torch.int32, device=dev)
    return q, pool[:, 0, 1], pool[:, 1, 1], null_pad(bt, DECODE_LENS), lens


def decode_long_case(dtype, dev, seed=3):
    """B sequences of LONG_LEN tokens each, on strided per-layer views
    of a (n_pages, 2, 2, P, H_kv, D) pool."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    pool, bt = make_pool(gen, dtype, dev, LONG_SLOTS)
    q = torch.randn((B, H, D), generator=gen, device=dev).to(dtype)
    lens = torch.full((B,), LONG_LEN, dtype=torch.int32, device=dev)
    return q, pool[:, 0, 1], pool[:, 1, 1], bt, lens


def prefill_case(dtype, dev, seed=2, window=WINDOW, starts=WIN_START,
                 ntoks=WIN_NTOK, heads=(H, HKV)):
    gen = torch.Generator(device=dev).manual_seed(seed)
    pool, bt = make_pool(gen, dtype, dev, hkv=heads[1])
    q = torch.randn((B, window, heads[0], D), generator=gen,
                    device=dev).to(dtype)
    start = torch.tensor(starts, dtype=torch.int32, device=dev)
    n_tok = torch.tensor(ntoks, dtype=torch.int32, device=dev)
    need = [s + n for s, n in zip(starts, ntoks)]
    return (q, pool[:, 0, 1], pool[:, 1, 1], null_pad(bt, need), start,
            n_tok)


def verify_case(dtype, dev, seed=4):
    """A verify window at the path's width: k+1 rows per sequence."""
    return prefill_case(dtype, dev, seed, SPEC_K + 1, VERIFY_START,
                        VERIFY_NTOK)


# ----------------------------------------------------------------------
# phase 2: what ptxas reports per kernel
# ----------------------------------------------------------------------
def _kernel_name(mangled: str) -> str:
    """``..._20flash_fwd_f32_kernelILi256EEEv...`` ->
    ``flash_fwd_f32_kernel<256>``: the last length-prefixed name that ends
    in ``_kernel`` (the namespace's hash before it may hold digits too),
    with its int and type template arguments."""
    found = None
    for m in re.finditer(r"\d+", mangled):
        digits = m.group(0)
        for i in range(len(digits)):
            name = mangled[m.end():m.end() + int(digits[i:])]
            if name.endswith("_kernel") and name.isidentifier() and \
                    mangled[m.end() + len(name):m.end() + len(name) + 1] \
                    in ("I", "E", "P", ""):
                found = name, mangled[m.end() + len(name):]
    if found is None:
        return mangled
    name, tail = found
    targs = re.match(r"I(.*?E)Ev", tail)
    args = [t.group(1) or {"f": "f32", "i": "i32"}.get(t.group(0), "bf16")
            for t in re.finditer(r"Li(\d+)E|13__nv_bfloat16|f|i",
                                 targs.group(1) if targs else "")]
    return name + (f"<{', '.join(args)}>" if args else "")


def ptxas_rows(log: str) -> list:
    """One dict per kernel of an ``nvcc -Xptxas -v`` log."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"kernel": _kernel_name(m.group(1)), "registers": None,
                   "static_smem": 0, "spill_stores": 0, "spill_loads": 0}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(sm.group(1)) if sm else 0
    return rows


def print_resources(fa, pa, sc, rc) -> None:
    """Registers, shared memory and spills of every kernel built, the
    dynamic shared memory of the redesigned kernels at their path's head
    dim (the copy engine's: its ring), and the blocks per SM of the f32
    prefill and decode bodies and the combine kernel."""
    from repro_torch.kernels import build

    for src, log in sorted(build.BUILD_LOG.items()):
        for r in ptxas_rows(log):
            print(f"ptxas {src}: {r['kernel']}: {r['registers']} registers, "
                  f"{r['static_smem']} B static smem, spill stores "
                  f"{r['spill_stores']} B / loads {r['spill_loads']} B",
                  flush=True)
    flib, plib = build.load(fa.SOURCE), build.load(pa.SOURCE)
    slib, rlib = build.load(sc.SOURCE), build.load(rc.SOURCE)
    pf32 = (f"paged_prefill_f32_kernel<{D}, "
            f"{plib.paged_prefill_tile_tokens_f32(D)}>")
    pd32 = (f"paged_decode_f32_kernel<{D}, "
            f"{plib.paged_decode_partition_tokens_f32(D)}, {H // HKV}>")
    print(f"dynamic smem per block: flash_fwd_f32_kernel<256> "
          f"{flib.flash_attention_smem_bytes_f32(FLASH_FULL['d'])} B, "
          f"flash_fwd_bf16_kernel<256> "
          f"{flib.flash_attention_smem_bytes_bf16(FLASH_FULL['d'])} B, "
          f"paged_prefill_mma_kernel<{D}> "
          f"{plib.paged_prefill_smem_bytes_bf16(D)} B, {pf32} "
          f"{plib.paged_prefill_smem_bytes_f32(D)} B, "
          f"paged_decode_bf16_kernel<{D}> "
          f"{plib.paged_decode_smem_bytes_bf16(D)} B, {pd32} "
          f"{plib.paged_decode_smem_bytes_f32(D)} B, copy_bulk_kernel "
          f"{slib.symm_copy_ring_bytes()} B (of 232448)", flush=True)
    blocks = plib.paged_prefill_blocks_per_sm_f32(D)
    blocks_d32 = plib.paged_decode_blocks_per_sm_f32(D)
    for name, n in ((pf32, blocks), (pd32, blocks_d32)):
        if n < 1:
            fail(f"{name}: no block fits an SM ({n})")
    print(f"blocks per SM: {pf32} {blocks} of "
          f"{pa.PREFILL_GROUPS_F32 * 128} threads "
          f"({pa.PREFILL_GROUPS_F32} token groups); {pd32} {blocks_d32} of "
          f"256 threads; combine_kernel<f32, sum, "
          f"4> {rlib.combine_blocks_per_sm()} of {rlib.combine_threads()} "
          f"threads resident, {rc.BLOCKS_PER_SM} launched per SM, "
          f"{rlib.combine_unroll()} vector pairs in flight per thread",
          flush=True)


# ----------------------------------------------------------------------
# phase 3: parity
# ----------------------------------------------------------------------
def parity(pa, dev) -> dict:
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        q, kp, vp, bt, lens = decode_case(dtype, dev)
        if kp.is_contiguous():
            fail("parity must run on a strided pool view")
        out = pa.paged_decode_attention(q, kp, vp, bt, lens)
        ref = pa.paged_decode_attention_ref(q, kp, vp, bt, lens)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        if not err <= DECODE_TOL[dtype]:
            fail(f"decode {tag}: max |kernel - plain| {err} > "
                 f"{DECODE_TOL[dtype]}")
        if out[0].abs().max().item() != 0.0:
            fail(f"decode {tag}: length-0 row is not exactly zero")
        q, kp, vp, bt, lens = decode_long_case(dtype, dev)
        out = pa.paged_decode_attention(q, kp, vp, bt, lens)
        ref = pa.paged_decode_attention_ref(q, kp, vp, bt, lens)
        torch.cuda.synchronize()
        long_err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        if not long_err <= min(DECODE_TOL[dtype], SCALE_TOL * scale):
            fail(f"decode {tag} at {LONG_LEN} tokens: max |kernel - plain| "
                 f"{long_err} > min({DECODE_TOL[dtype]}, {SCALE_TOL} x max "
                 f"|plain| {scale})")
        if not torch.equal(out, pa.paged_decode_attention(q, kp, vp, bt,
                                                          lens)):
            fail(f"decode {tag}: two calls differ")
        errs[("paged_decode_attention", tag)] = max(err, long_err)
        del q, kp, vp, out, ref

        q, kp, vp, bt, start, n_tok = prefill_case(dtype, dev)
        out = pa.paged_prefill_attention(q, kp, vp, bt, start, n_tok)
        ref = pa.paged_prefill_attention_ref(q, kp, vp, bt, start, n_tok)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        if not err <= TOL[dtype]:
            fail(f"prefill {tag}: max |kernel - plain| {err} > {TOL[dtype]}")
        pad = torch.arange(WINDOW, device=dev)[None] >= n_tok[:, None]
        if out[pad].abs().max().item() != 0.0:
            fail(f"prefill {tag}: padded/inactive rows are not exactly zero")
        q, kp, vp, bt, start, n_tok = verify_case(dtype, dev)
        out = pa.paged_prefill_attention(q, kp, vp, bt, start, n_tok)
        ref = pa.paged_prefill_attention_ref(q, kp, vp, bt, start, n_tok)
        torch.cuda.synchronize()
        v_err = (out.float() - ref.float()).abs().max().item()
        if not v_err <= TOL[dtype]:
            fail(f"verify window {tag}: max |kernel - plain| {v_err} > "
                 f"{TOL[dtype]}")
        pad = torch.arange(SPEC_K + 1, device=dev)[None] >= n_tok[:, None]
        if out[pad].abs().max().item() != 0.0:
            fail(f"verify window {tag}: padded rows are not exactly zero")
        errs[("paged_prefill_attention", tag)] = max(err, v_err)
        print(f"parity {tag}: decode max_err="
              f"{errs[('paged_decode_attention', tag)]:.3e} (timing shape and "
              f"{LONG_LEN} tokens, there {long_err:.3e} against max |plain| "
              f"{scale:.3e}; two calls equal; tol {DECODE_TOL[dtype]}) "
              f"prefill max_err={err:.3e}, verify window ({B} x {SPEC_K + 1} "
              f"rows) {v_err:.3e} (tol {TOL[dtype]})", flush=True)
    moe_layout_parity(pa, dev, errs)
    return errs


def moe_layout_parity(pa, dev, errs) -> None:
    """Decode and the 64-row prefill window at the MoE archs' layouts
    (qwen3-moe-30b-a3b: H 32 / H_kv 4, group 8; qwen2-moe-a2.7b: H 16 /
    H_kv 16, group 1; D 128) in both dtypes, against the plain versions
    with phase 3's tolerances; length-0 and padded rows exactly 0.  The
    errors join ``errs``."""
    for arch, (heads, _) in MOE_HEADS.items():
        for dtype in (torch.bfloat16, torch.float32):
            tag = "f32" if dtype == torch.float32 else "bf16"
            q, kp, vp, bt, lens = decode_case(dtype, dev, seed=5,
                                              heads=heads)
            out = pa.paged_decode_attention(q, kp, vp, bt, lens)
            ref = pa.paged_decode_attention_ref(q, kp, vp, bt, lens)
            q, kp, vp, bt, start, n_tok = prefill_case(dtype, dev, seed=6,
                                                       heads=heads)
            pout = pa.paged_prefill_attention(q, kp, vp, bt, start, n_tok)
            pref = pa.paged_prefill_attention_ref(q, kp, vp, bt, start,
                                                  n_tok)
            torch.cuda.synchronize()
            d_err = (out.float() - ref.float()).abs().max().item()
            p_err = (pout.float() - pref.float()).abs().max().item()
            pad = torch.arange(WINDOW, device=dev)[None] >= n_tok[:, None]
            if not d_err <= DECODE_TOL[dtype] or \
                    out[0].abs().max().item() != 0.0:
                fail(f"decode {tag} at {arch}'s layout {heads}: max |kernel "
                     f"- plain| {d_err} (tol {DECODE_TOL[dtype]}), or the "
                     f"length-0 row is not exactly zero")
            if not p_err <= TOL[dtype] or pout[pad].abs().max().item() != 0:
                fail(f"prefill {tag} at {arch}'s layout {heads}: max |kernel "
                     f"- plain| {p_err} (tol {TOL[dtype]}), or padded rows "
                     f"are not exactly zero")
            for name, e in (("paged_decode_attention", d_err),
                            ("paged_prefill_attention", p_err)):
                errs[(name, tag)] = max(errs[(name, tag)], e)
            print(f"parity {tag} at {arch}'s layout (H {heads[0]}, H_kv "
                  f"{heads[1]}, D {D}): decode max_err={d_err:.3e}, prefill "
                  f"max_err={p_err:.3e}", flush=True)
            del q, kp, vp, out, ref, pout, pref


def flash_inputs(shape, dtype, dev, seed=11):
    """q as the model hands it over: a (B, H, T, D) view of a (B, T, H,
    D) tensor; k, v contiguous (B, H_kv, S, D)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    b, h, hkv, t, s, d = (shape[k] for k in ("b", "h", "hkv", "t", "s", "d"))
    q = torch.randn((b, t, h, d), generator=g, device=dev).to(dtype)
    k = torch.randn((b, hkv, s, d), generator=g, device=dev).to(dtype)
    v = torch.randn((b, hkv, s, d), generator=g, device=dev).to(dtype)
    return q.transpose(1, 2), k, v


def flash_parity(fa, dev) -> dict:
    """The flash kernel against its plain version, output and lse."""
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        worst = 0.0
        for shape, opts in FLASH_CASES:
            q, k, v = flash_inputs(shape, dtype, dev)
            out, lse = fa.flash_attention(q, k, v, **opts)
            ref, ref_lse = fa.flash_attention_ref(q, k, v, **opts)
            torch.cuda.synchronize()
            err = max((out.float() - ref.float()).abs().max().item(),
                      (lse - ref_lse).abs().max().item())
            if not err <= TOL[dtype]:
                fail(f"flash {tag} {shape} {opts}: max |kernel - plain| "
                     f"{err} > {TOL[dtype]}")
            worst = max(worst, err)
            del q, k, v, out, lse, ref, ref_lse
        errs[tag] = worst
    torch.cuda.empty_cache()
    print(f"parity flash_attention: max |kernel - plain| over out and lse, "
          f"{len(FLASH_CASES)} shapes: f32 {errs['f32']:.3e} (tol "
          f"{TOL[torch.float32]}), bf16 {errs['bf16']:.3e} (tol "
          f"{TOL[torch.bfloat16]})", flush=True)
    return errs


def flash_autograd_parity(fa, dev) -> float:
    """blocked_attention with the kernel forward (one launch) and the
    plain blocked backward against the all-plain path: output and
    q/k/v grads, f32, gemma's head shape, ragged T."""
    from repro_torch.models.flash import blocked_attention

    g = torch.Generator(device=dev).manual_seed(12)
    shapes = ((1, 300, 8, 256), (1, 300, 1, 256), (1, 300, 1, 256))
    base = [torch.randn(sh, generator=g, device=dev) for sh in shapes]
    dout = torch.randn(shapes[0], generator=g, device=dev)
    res = {}
    for impl in ("kernel", "ref"):
        q, k, v = (x.clone().requires_grad_(True) for x in base)
        n = fa.LAUNCHES["flash_attention"]
        out = blocked_attention(q, k, v, block_q=128, block_kv=64, impl=impl)
        if fa.LAUNCHES["flash_attention"] != n + (impl == "kernel"):
            fail("autograd: the kernel path did not launch the kernel once")
        out.backward(dout)
        res[impl] = [out.detach(), q.grad, k.grad, v.grad]
    err = max((a - b).abs().max().item()
              for a, b in zip(res["kernel"], res["ref"]))
    if not err <= TOL[torch.float32]:
        fail(f"autograd: kernel path vs plain path max err {err}")
    print(f"parity flash autograd (kernel fwd + plain bwd vs plain, f32): "
          f"max err over out/dq/dk/dv {err:.3e}", flush=True)
    return err


def _bits(n_bytes, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, 256, (n_bytes,), dtype=torch.uint8, generator=g,
                         device=dev)


def _same_bytes(a, b) -> bool:
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def _same_bits(got, want) -> bool:
    """Equal bit for bit (so -0.0 is not +0.0), save where both are NaN:
    which NaN an operation returns is not specified."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    if not got.is_floating_point():
        return torch.equal(got, want)
    bits = {2: torch.int16, 4: torch.int32}[got.element_size()]
    same = (got.view(bits) == want.view(bits)) | (got.isnan() & want.isnan())
    return bool(same.all())


def comm_kernel_parity(sc, rc, dev) -> dict:
    """The copy engine and the combine kernel against their plain
    versions, bit for bit (the copy is an identity; the combine is one
    IEEE operation per element, bf16 rounded once, as PyTorch does);
    then the pallas backend against posh in bf16."""
    from repro_torch import comm as C
    from repro_torch.launch import comm_bench as cb

    err = {"copy_blocked": 0.0, "combine_blocked": 0.0}
    n = STAGED[0] * STAGED[1]
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(STAGED, generator=g, device=dev)
    for variant in sc.VARIANTS:                  # finite values: an error
        d = sc.copy_blocked(x, variant) - sc.copy_blocked_ref(x, variant)
        err["copy_blocked"] = max(err["copy_blocked"], d.abs().max().item())
    for dtype in (torch.float32, torch.bfloat16, torch.int8, torch.int32):
        item = torch.empty((), dtype=dtype).element_size()
        x = _bits(n * item, dev, 1).view(dtype).view(STAGED)
        ragged = _bits(N_PE * 4099 * item, dev, 2).view(dtype).view(N_PE, -1)
        odd = _bits(n * item + 64, dev, 3)[3:3 + n * item]   # misaligned
        for variant in sc.VARIANTS:
            for t in (x, ragged, odd):
                got = sc.copy_blocked(t, variant)
                if not _same_bytes(got, sc.copy_blocked_ref(t, variant)):
                    fail(f"copy_blocked {variant} {dtype} {tuple(t.shape)}: "
                         "not the plain version's bytes")
    torch.cuda.synchronize()
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        a = torch.randn(STAGED, generator=g, device=dev) * 3
        b = torch.randn(STAGED, generator=g, device=dev) * 3
        if dtype == torch.int32:
            a, b = (a * 1000).to(dtype), (b * 1000).to(dtype)
        else:
            a.view(-1)[::97] = float("nan")
            b.view(-1)[::89] = float("nan")
            a, b = a.to(dtype), b.to(dtype)
        # whole, misaligned by one element, a length that is no multiple
        # of the vectors in flight (128 threads x 4 pairs), below one vector
        la, lb = a.view(-1), b.view(-1)
        views = ((a, b), (la[1:], lb[1:]), (la[:1000003], lb[:1000003]),
                 (la[:3], lb[:3]))
        for op in ("sum", "prod", "max", "min"):
            for x, y in views:
                got = rc.combine_blocked(x, y, op)
                want = rc.combine_blocked_ref(x, y, op)
                if not _same_bits(got, want):
                    fail(f"combine_blocked {op} {dtype}: differs from the "
                         "plain version")
                got, want = got.double(), want.double()
                fin = want.isfinite() & got.isfinite()
                err["combine_blocked"] = max(
                    err["combine_blocked"],
                    (got[fin] - want[fin]).abs().max().item())
    torch.cuda.synchronize()
    posh = C.make_communicator("pe", size=N_PE, backend="posh")
    pal = C.make_communicator("pe", size=N_PE, backend="pallas")
    for elems in (64, 8200, 1 << 18):
        x = torch.randn((N_PE, elems), generator=g, device=dev).to(
            torch.bfloat16)
        for op in cb.COMM_OPS:
            if not torch.equal(cb.comm_call(pal, op, x),
                               cb.comm_call(posh, op, x)):
                fail(f"pallas != posh in bf16: {op} at {elems} elements")
    print("parity comm kernels: copy_blocked bit-exact (4 dtypes x 5 "
          "variants x aligned/ragged/misaligned), combine_blocked bit-exact "
          "(4 ops x f32/bf16/int32, NaNs, misaligned, ragged, below one "
          "vector), pallas == posh in "
          f"bf16; max |kernel - plain| {err}", flush=True)
    return err


# ----------------------------------------------------------------------
# phase 4: serve
# ----------------------------------------------------------------------
def serve_full(pa, dev):
    from repro_torch.launch.serve import build_engine
    from repro_torch.serve import TrafficConfig, make_requests

    t0 = time.monotonic()
    eng, cfg = build_engine("qwen3-8b", config="full", dtype="bf16",
                            device=dev, page_tokens=P, n_pages=512,
                            max_batch=B, prefill_chunk=64,
                            attn_impl="kernel", seed=0)
    torch.cuda.synchronize()
    print(f"serve: qwen3-8b full width, {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv}, head_dim "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; bf16 "
          f"weights {torch.cuda.memory_allocated() / 1e9:.2f} GB on the "
          f"card, init {time.monotonic() - t0:.1f} s", flush=True)
    tcfg = TrafficConfig(vocab=cfg.vocab, **SERVE_TRACE)
    # warm-up on a throwaway trace (cuBLAS handles, the kernels' first
    # launches), then a clean measured run on the same engine
    eng.run(make_requests(TrafficConfig(vocab=cfg.vocab, **WARMUP_TRACE)))
    eng.reset_metrics()
    reqs = make_requests(tcfg)

    pa.reset_launches()
    torch.cuda.synchronize()
    t1 = time.monotonic()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.monotonic() - t1
    launches = dict(pa.LAUNCHES)

    m = eng.metrics()
    if len(done) != len(reqs):
        fail(f"serve: {len(done)} of {len(reqs)} requests finished")
    for r in done:
        if len(r.out) != r.max_new or not all(0 <= t < cfg.vocab
                                              for t in r.out):
            fail(f"serve: request {r.rid} produced {r.out}")
    want = {"paged_prefill_attention": cfg.n_layers * m["steps"]["prefill"],
            "paged_decode_attention": cfg.n_layers * m["steps"]["decode"]}
    if launches != want or min(launches.values()) == 0:
        fail(f"serve: kernel launches {launches} != n_layers x steps {want}")
    prompts = [r.n_prompt for r in reqs]
    print(f"serve: {len(done)} requests, prompts {min(prompts)}-"
          f"{max(prompts)} tokens, {m['tokens_out']} tokens out, "
          f"{m['steps']['prefill']} prefill steps, {m['steps']['decode']} "
          f"decode steps, launches {launches}", flush=True)
    print("serve metrics: " + json.dumps(
        {k: m[k] for k in ("requests", "tokens_out", "span_s",
                           "throughput_tok_s", "ttft_p50_s", "ttft_p99_s",
                           "decode_p50_s", "decode_p99_s", "latency_p50_s",
                           "latency_p99_s", "ticks", "steps")}), flush=True)
    profile_serve(eng, make_requests(tcfg))
    # the speculative, prefix-migration and SLO paths on the same weights
    t0 = time.monotonic()
    base = {"ticks": m["ticks"], "wall_s": wall,
            "tok_s": m["tokens_out"] / wall, "tokens_out": m["tokens_out"]}
    launches_spec = serve_spec_bf16(pa, eng, cfg, tcfg, done, base)
    serve_prefix_full(eng, cfg)
    serve_slo_full(eng, cfg)
    print(f"serve spec/prefix/slo parts (bf16): "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    t0 = time.monotonic()
    launches_disagg, colo, colo_peak = serve_disagg_bf16(pa, eng, cfg)
    print(f"serve disagg part (bf16): {time.monotonic() - t0:.1f} s",
          flush=True)
    del eng
    torch.cuda.empty_cache()
    return launches, launches_spec, launches_disagg, colo, colo_peak


def serve_full_f32(pa, dev) -> dict:
    """Full-width qwen3-8b served in f32, the reference's serving dtype:
    first-step logits of the kernel path against the plain path, then a
    seeded trace whose f32 paged-attention launches, zeroed just before,
    must equal n_layers x the run's steps (and no bf16 body may run);
    then speculation and the disaggregated cells on the same weights.
    Returns the run's launches by (kernel, dtype) and the disagg runs'."""
    from repro_torch.launch.serve import build_engine
    from repro_torch.serve import TrafficConfig, make_requests

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    eng, cfg = build_engine("qwen3-8b", config="full", dtype="f32",
                            device=dev, page_tokens=P, n_pages=512,
                            max_batch=B, prefill_chunk=64,
                            attn_impl="kernel", seed=0)
    torch.cuda.synchronize()
    print(f"serve f32: qwen3-8b full width, {cfg.n_layers} layers; f32 "
          f"weights and pool {torch.cuda.memory_allocated() / 1e9:.2f} GB on "
          f"the card, init {time.monotonic() - t0:.1f} s", flush=True)
    reqs = make_requests(TrafficConfig(vocab=cfg.vocab, **SERVE_TRACE_F32))
    first_step_logits(eng, cfg, reqs)

    pa.reset_launches()
    torch.cuda.synchronize()
    t1 = time.monotonic()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.monotonic() - t1
    launches = dict(pa.LAUNCHES_BY_DTYPE)
    m = eng.metrics()
    if len(done) != len(reqs):
        fail(f"serve f32: {len(done)} of {len(reqs)} requests finished")
    for r in done:
        if len(r.out) != r.max_new or not all(0 <= t < cfg.vocab
                                              for t in r.out):
            fail(f"serve f32: request {r.rid} produced {r.out}")
    want = {(name, tag): 0 for name, tag in launches}
    want[("paged_prefill_attention", "f32")] = \
        cfg.n_layers * m["steps"]["prefill"]
    want[("paged_decode_attention", "f32")] = \
        cfg.n_layers * m["steps"]["decode"]
    if launches != want or not (m["steps"]["prefill"] and
                                m["steps"]["decode"]):
        fail(f"serve f32: kernel launches {launches} != n_layers x steps "
             f"{want}")
    base_streams = streams_of(done)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"serve f32: {len(done)} requests, {m['tokens_out']} tokens out, "
          f"{m['steps']['prefill']} prefill steps, {m['steps']['decode']} "
          f"decode steps, f32 launches prefill "
          f"{launches[('paged_prefill_attention', 'f32')]} decode "
          f"{launches[('paged_decode_attention', 'f32')]} (bf16 bodies 0)",
          flush=True)
    print("serve f32 metrics: " + json.dumps(
        {"wall_s": wall, "throughput_tok_s": m["throughput_tok_s"],
         "tokens_out": m["tokens_out"], "peak_memory_gb": peak,
         **{k: m[k] for k in ("span_s", "ttft_p50_s", "ttft_p99_s",
                              "decode_p50_s", "decode_p99_s", "ticks",
                              "steps")}}), flush=True)
    t0 = time.monotonic()
    serve_spec_f32(pa, eng, cfg, base_streams)
    print(f"serve spec part (f32): {time.monotonic() - t0:.1f} s", flush=True)
    t0 = time.monotonic()
    launches_disagg = serve_disagg_f32(pa, eng, cfg, base_streams)
    print(f"serve disagg part (f32): {time.monotonic() - t0:.1f} s",
          flush=True)
    del eng
    torch.cuda.empty_cache()
    return launches, launches_disagg


def streams_of(done) -> dict:
    return {r.rid: list(r.out) for r in done}


def spec_scfg(eng):
    """The engine's serving config with speculation on, and a tick budget
    that covers every verify window and every prefilling sequence's whole
    chunk, so the prefill chunking is the same whatever the proposer
    accepts."""
    sc = eng.scfg
    return dataclasses.replace(
        sc, spec_k=SPEC_K,
        tick_tokens=sc.max_batch * (1 + SPEC_K + sc.prefill_chunk))


def divergences(got: dict, want: dict) -> list:
    """(rid, output index) of the first token where each stream of
    ``got`` leaves ``want``'s, for every stream that does, by rid."""
    out = []
    for rid in sorted(want):
        a, b = got.get(rid, []), want[rid]
        j = next((j for j in range(max(len(a), len(b)))
                  if j >= len(a) or j >= len(b) or a[j] != b[j]), None)
        if j is not None:
            out.append((rid, j))
    return out


def first_divergence(got: dict, want: dict):
    """(rid, output index) of the first diverging stream, or None."""
    div = divergences(got, want)
    return div[0] if div else None


def decode_logits(eng, cfg, cases, window_decode: bool = False) -> list:
    """The non-speculative path's logits for output ``j`` of each of
    ``cases`` ((prompt, outputs, j), at most max_batch of them), one case
    a row of the serve run's shapes: the prompts through 64-token prefill
    windows, outputs 0..j-1 through decode steps, on a fresh pool; a row
    that has nothing to feed in a step sits idle on page 0, as the
    engine's idle rows do.  ``window_decode`` feeds the outputs through
    one-row windows of the prefill trunk instead, what a verify window's
    rows compute.  Returns each case's (V,) logits."""
    from repro_torch.models import embed as emb
    from repro_torch.parallel import tp_of
    from repro_torch.serve import engine as se

    scfg, params, dev = eng.scfg, eng.exec.params, eng.device
    ctx = eng.ctx
    bm, c, pt = scfg.max_batch, scfg.prefill_chunk, scfg.page_tokens
    if len(cases) > bm:
        raise ValueError(f"{len(cases)} cases for {bm} rows")
    table = torch.zeros((bm, scfg.table_slots), dtype=torch.int32)
    base = 1
    for i, (prompt, _, j) in enumerate(cases):
        need = -(-(len(prompt) + j + 1) // pt)
        table[i, :need] = base + torch.arange(need, dtype=torch.int32)
        base += need
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    window = se._make_window_forward(cfg, scfg, ctx)
    decode = se._make_decode_forward(cfg, scfg, ctx)

    def full_logits(xrow):
        # at tp > 1 each shard's logits, in vocab order
        if tp_of(ctx) == 1:
            return emb.lm_head_logits(head, xrow)
        return emb.lm_head_logits(head, xrow[:, None], ctx).reshape(-1)
    pool = eng.exec.init_pool()
    z = lambda: torch.zeros((bm,), dtype=torch.int32)   # noqa: E731
    logits = [None] * len(cases)

    def rows(active):
        bt = torch.zeros_like(table)
        bt[active] = table[active]
        return bt.to(dev)

    n_chunks = max(-(-len(p) // c) for p, _, _ in cases)
    for k in range(n_chunks):
        ids = torch.zeros((bm, c), dtype=torch.int32)
        start, n_tok, active = z(), z(), []
        for i, (prompt, _, _) in enumerate(cases):
            chunk = prompt[k * c:(k + 1) * c]
            if chunk:
                ids[i, :len(chunk)] = torch.tensor(chunk, dtype=torch.int32)
                start[i], n_tok[i] = k * c, len(chunk)
                active.append(i)
        x, pool = window(params, pool, ids.to(dev), start.to(dev),
                         n_tok.to(dev), rows(active))
        for i in active:
            if (k + 1) * c >= len(cases[i][0]):
                logits[i] = full_logits(x[..., i, int(n_tok[i]) - 1, :])
    for t in range(max(j for _, _, j in cases)):
        tok, pos, lens, active = z(), z(), z(), []
        for i, (prompt, outs, j) in enumerate(cases):
            if t < j:
                n = len(prompt) + t
                tok[i], pos[i], lens[i] = outs[t], n, n + 1
                active.append(i)
        if window_decode:
            x, pool = window(params, pool, tok[:, None].to(dev),
                             pos.to(dev), (lens > 0).to(torch.int32).to(dev),
                             rows(active))
            x = x[..., 0, :]
        else:
            x, pool = decode(params, pool, tok.to(dev), pos.to(dev),
                             rows(active), lens.to(dev))
        for i in active:
            if t == cases[i][2] - 1:
                logits[i] = full_logits(x[..., i, :])
    del pool
    return logits


def decode_margins(eng, cfg, cases) -> list:
    """(top-1 minus top-2 logit, top-1 token, top-1 logit) of
    ``decode_logits`` per case."""
    out = []
    for lg in decode_logits(eng, cfg, cases):
        top = lg.float().topk(2)
        out.append(((top.values[0] - top.values[1]).item(),
                    int(top.indices[0]), top.values[0].item()))
    return out


def spec_run(pa, eng, cfg, reqs, proposer=None, kv=None, clock="tick",
             profile_reqs=None):
    """One speculative run of ``reqs`` on a second engine over ``eng``'s
    weights (only its pool is new), the launch counters zeroed just
    before; then, given ``profile_reqs``, ``profile_verify`` on the same
    engine.  Returns (streams, metrics,
    launches by (kernel, dtype), wall seconds, the draft's step
    counts)."""
    from repro_torch.serve import ServeEngine

    e2 = ServeEngine(eng.exec.params, cfg, spec_scfg(eng), device=eng.device,
                     kv=kv, proposer=proposer)
    pa.reset_launches()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    done = e2.run(reqs, clock=clock)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(pa.LAUNCHES_BY_DTYPE)
    m = e2.metrics()
    if len(done) != len(reqs) or any(len(r.out) != r.max_new for r in done):
        fail(f"spec run: {len(done)} of {len(reqs)} requests finished whole")
    if m["steps"]["decode"] or not m["steps"]["verify"]:
        fail(f"spec run: steps {m['steps']}: every decode token must come "
             f"from a verify window")
    dsteps = dict(getattr(e2.proposer, "steps",
                          {"prefill": 0, "decode": 0}))
    got = streams_of(done)
    if profile_reqs is not None:             # after the run's results:
        profile_verify(e2, profile_reqs)     # it resets the engine
    del e2
    return got, m, launches, wall, dsteps


def spec_launches_ok(launches, cfg, m, dsteps, tag) -> dict:
    """The prefill body of ``tag`` launches n_layers x (prefill steps +
    verify ticks + the draft's prefill steps), the decode body n_layers x
    the draft's decode steps, the other dtype's bodies never."""
    want = {k: 0 for k in launches}
    want[("paged_prefill_attention", tag)] = cfg.n_layers * (
        m["steps"]["prefill"] + m["steps"]["verify"] + dsteps["prefill"])
    want[("paged_decode_attention", tag)] = cfg.n_layers * dsteps["decode"]
    if launches != want:
        fail(f"spec run ({tag}): kernel launches {launches} != {want}")
    return want


def spec_proposer_runs(pa, eng, cfg, tcfg, tag, names, replay=None,
                       profile=False) -> tuple:
    """Speculative runs (k = SPEC_K) of the trace ``tcfg`` on a second
    engine over ``eng``'s weights, one per proposer of ``names``, in
    order: "ngram", "replay" (of ``replay``, or of the n-gram run's
    streams), "fixed" ([0, 1, 2, 3]) and "draft" (a draft model with the
    target's own weights and config; its own pool only).  The runs'
    streams must be identical (the verify window is k+1 rows whatever is
    proposed); replay must accept every proposal and emit more than one
    token a tick, the draft model more than one a tick.  Returns (results
    by proposer, launches summed over the runs by (kernel, dtype))."""
    from repro_torch.core.heap import SymmetricHeap
    from repro_torch.serve import (DraftModelProposer, FixedProposer,
                                   NgramProposer, PagedKVCache,
                                   ReplayProposer, make_requests)

    total: dict = {}
    res = {}
    for name in names:
        kv = None
        if name == "draft":
            sc = spec_scfg(eng)
            kv = PagedKVCache(
                SymmetricHeap(("data",)), n_layers=cfg.n_layers,
                kv_heads=cfg.kv_per_rank(1), head_dim=cfg.head_dim,
                n_pages=sc.n_pages, page_tokens=sc.page_tokens,
                dtype=sc.dtype)
            prop = DraftModelProposer(eng.exec.params, cfg, sc, kv,
                                      target_vocab=cfg.vocab,
                                      device=eng.device)
        elif name == "replay":
            prop = ReplayProposer(replay if replay is not None
                                  else res["ngram"]["streams"])
        else:
            prop = {"ngram": NgramProposer,
                    "fixed": lambda: FixedProposer([0, 1, 2, 3])}[name]()
        got, m, launches, wall, dsteps = spec_run(
            pa, eng, cfg, make_requests(tcfg), prop, kv,
            profile_reqs=make_requests(tcfg)
            if profile and name == "ngram" else None)
        del prop, kv
        torch.cuda.empty_cache()
        spec_launches_ok(launches, cfg, m, dsteps, tag)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        res[name] = dict(streams=got, ticks=m["ticks"], wall_s=wall,
                         tok_s=m["tokens_out"] / wall,
                         accept_rate=m["spec"]["accept_rate"],
                         tokens_per_tick=m["spec"]["tokens_per_tick"],
                         verify_ticks=m["steps"]["verify"],
                         prefill_steps=m["steps"]["prefill"],
                         draft_steps=dsteps,
                         launches={f"{k[0]}/{k[1]}": v
                                   for k, v in launches.items() if v})
    ref = res[names[0]]["streams"]
    for name, r in res.items():
        if r["streams"] != ref:
            fail(f"spec {tag}: the {name} run's streams differ from the "
                 f"{names[0]} run's at {first_divergence(r['streams'], ref)}"
                 f": the target's tokens depend on the proposer")
    if "replay" in res and res["replay"]["accept_rate"] != 1.0:
        fail(f"spec {tag}: replay of the target's own streams accepted "
             f"{res['replay']['accept_rate']} of its proposals, not all")
    for name in ("replay", "draft"):
        if name in res and not res[name]["tokens_per_tick"] > 1:
            fail(f"spec {tag}: {name} tokens per tick "
                 f"{res[name]['tokens_per_tick']} <= 1")
    return res, total


def margin_text(eng, cfg, reqs, spec: dict, plain: dict,
                labels=("spec", "non-spec")) -> tuple:
    """Every stream where ``spec`` leaves ``plain`` (the non-spec run's
    streams of ``reqs``, or another run's named by ``labels``): (number
    of equal streams, text with each first divergence and the plain
    run's top-2 logit margin there)."""
    div = divergences(spec, plain)
    prompts = {r.rid: r.prompt for r in reqs}
    margins = decode_margins(eng, cfg, [(prompts[rid], plain[rid], j)
                                        for rid, j in div]) if div else []
    a, b = labels
    text = "; ".join(
        f"request {rid} output {j}: {a} {spec[rid][j:j + 3]} vs {b} "
        f"{plain[rid][j:j + 3]}, {b} top-2 margin {mg:.6g} (top-1 "
        f"{top})" for (rid, j), (mg, top, _) in zip(div, margins))
    return len(plain) - len(div), text


def serve_spec_bf16(pa, eng, cfg, tcfg, base_done, base) -> dict:
    """Full-width bf16 speculative decoding of the serve trace with four
    proposers (``spec_proposer_runs``: n-gram, replay of the n-gram
    run's streams, fixed, draft model).  Agreement with the non-spec run
    is reported, with every diverging stream's first divergence and its
    top-2 margin; where no stream diverges, the draft model must accept
    every proposal too.  Returns the launches summed over the runs."""
    res, total = spec_proposer_runs(
        pa, eng, cfg, tcfg, "bf16", ("ngram", "replay", "fixed", "draft"),
        profile=True)
    want = streams_of(base_done)
    same, text = margin_text(eng, cfg, base_done, res["ngram"]["streams"],
                             want)
    if same == len(want):
        agree = "spec streams == non-spec streams"
        if res["draft"]["accept_rate"] != 1.0:
            fail(f"spec bf16: draft accept rate "
                 f"{res['draft']['accept_rate']} != 1.0 with streams equal "
                 f"to the non-spec run's")
    else:
        agree = (f"spec streams differ from non-spec: {same} of {len(want)} "
                 f"streams equal; first divergences: {text}")
    print(f"serve spec bf16 (k={SPEC_K}): four proposers' streams "
          f"identical, replay accepts all; {agree}", flush=True)
    print("serve spec bf16 runs: " + json.dumps(
        {"non_spec": base,
         **{n: {k: v for k, v in r.items() if k != "streams"}
            for n, r in res.items()}}), flush=True)
    return total


def serve_spec_f32(pa, eng, cfg, base_streams) -> None:
    """Full-width f32 speculative decoding of the f32 trace with the
    n-gram proposer, replay of the f32 non-spec streams and a draft
    model with the target's own weights (``spec_proposer_runs``): the
    streams must equal the f32 non-spec run's (the prefill body's rows
    against the decode body's tokens), and replay and the draft model,
    which then propose exactly the target's tokens, must accept every
    proposal."""
    from repro_torch.serve import TrafficConfig, make_requests

    tcfg = TrafficConfig(vocab=cfg.vocab, **SERVE_TRACE_F32)
    res, _ = spec_proposer_runs(pa, eng, cfg, tcfg, "f32",
                                ("ngram", "replay", "draft"),
                                replay=base_streams)
    same, text = margin_text(eng, cfg, make_requests(tcfg),
                             res["ngram"]["streams"], base_streams)
    if same != len(base_streams):
        fail(f"serve spec f32: {len(base_streams) - same} streams differ "
             f"from the non-spec run's: {text}")
    if res["draft"]["accept_rate"] != 1.0:
        fail(f"serve spec f32: draft accept rate "
             f"{res['draft']['accept_rate']} != 1.0 with streams equal to "
             f"the non-spec run's")
    print(f"serve spec f32 (k={SPEC_K}): ngram, replay and draft streams "
          f"== non-spec f32 streams, replay and draft accept all; "
          + json.dumps({n: {k: v for k, v in r.items() if k != "streams"}
                        for n, r in res.items()}), flush=True)


def serve_prefix_full(eng, cfg) -> None:
    """Prefix-cache migration at full width in bf16: a 200-token prompt
    served once (chunks 64, 64, 64, 8; its 12 full pages pinned), then
    again after it finished: the second admission is a prefix hit whose
    12 pages arrive by put_nbi with ONE quiet on that tick, it re-feeds
    only rows 192-199 (the first serve's last chunk), and its greedy
    stream must equal the first's bit for bit."""
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.serve import engine as se

    dev = eng.device
    e2 = ServeEngine(eng.exec.params, cfg,
                     dataclasses.replace(eng.scfg, prefix_keep=True),
                     device=dev)
    gen = torch.Generator().manual_seed(5)
    prompt = torch.randint(cfg.vocab, (PREFIX_PROMPT,), generator=gen).tolist()
    first = e2.run([Request(rid=0, prompt=list(prompt),
                            max_new=PREFIX_NEW)], clock="tick")[0]
    pages = PREFIX_PROMPT // e2.scfg.page_tokens
    if first.prefill_chunks != [64, 64, 64, 8] or \
            e2.kv.pinned_pages != pages:
        fail(f"prefix: first serve chunks {first.prefill_chunks}, pinned "
             f"{e2.kv.pinned_pages} pages (want [64, 64, 64, 8], {pages})")
    e2.submit(Request(rid=1, prompt=list(prompt), max_new=PREFIX_NEW))
    drained = []                     # the stats of every queue drained

    class Counted(se.CommQueue):
        def quiet(self):
            out = super().quiet()
            drained.append(self.stats())
            return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    mem0 = torch.cuda.memory_allocated(dev)
    plain_queue, se.CommQueue = se.CommQueue, Counted
    try:
        t0 = time.monotonic()
        e2.tick(e2.ticks)
        torch.cuda.synchronize()
        tick_ms = (time.monotonic() - t0) * 1e3
    finally:
        se.CommQueue = plain_queue
    peak_extra = (torch.cuda.max_memory_allocated(dev) - mem0) / 1e6
    got = [(st["puts"], st["quiets"]) for st in drained]
    if (e2.kv.stats["prefix_hits"], e2.kv.stats["migrations"], got) != \
            (1, pages, [(pages, 1)]):
        fail(f"prefix: hits {e2.kv.stats['prefix_hits']}, migrations "
             f"{e2.kv.stats['migrations']}, drained queues (puts, quiets) "
             f"{got} (want 1, {pages}, [({pages}, 1)])")
    st = drained[0]
    while e2.sched.has_work():
        e2.tick(e2.ticks)
    second = next(r for r in e2.finished if r.rid == 1)
    if second.prefill_chunks != [PREFIX_PROMPT - pages * P] or \
            second.out != first.out:
        fail(f"prefix: resumed chunks {second.prefill_chunks}, stream "
             f"{second.out} vs first {first.out}")
    page_mb = e2.pool[0].numel() * e2.pool.element_size() / 1e6
    print(f"serve prefix bf16: {pages} pages ({page_mb:.2f} MB each) "
          f"migrated by {st['puts']} put_nbi ({st['coalesced']} coalesced) "
          f"and {st['quiets']} quiet; resumed stream == first stream "
          f"{first.out[:6]}...; migrating tick {tick_ms:.1f} ms wall, peak "
          f"memory over it +{peak_extra:.1f} MB above "
          f"{mem0 / 1e9:.2f} GB", flush=True)
    del e2
    torch.cuda.empty_cache()


def serve_slo_full(eng, cfg) -> None:
    """The SLO policy at full width in bf16 on the tick clock: the SLO
    trace served FCFS and under ``--slo 0.5+0.25`` with TTFT deadlines,
    on a pool small enough to evict; every request the SLO run serves
    must give the FCFS run's stream.  Prints attainment and sheds."""
    from repro_torch.serve import (SLOConfig, ServeEngine, TrafficConfig,
                                   make_requests)

    slo = SLOConfig(**{f"ttft_{c}": t for c, t in SLO_TTFT.items()})
    tcfg = TrafficConfig(vocab=cfg.vocab, **SLO_TRACE, **{
        f"deadline_{c}": t for c, t in SLO_TTFT.items()})
    out = {}
    for mode, pol in (("fcfs", None), ("slo", slo)):
        e2 = ServeEngine(eng.exec.params, cfg, dataclasses.replace(
            eng.scfg, n_pages=SLO_PAGES, slo=pol), device=eng.device)
        t0 = time.monotonic()
        done = e2.run(make_requests(tcfg), clock="tick")
        torch.cuda.synchronize()
        m = e2.metrics()
        out[mode] = (streams_of(done), m, time.monotonic() - t0)
        del e2
    (fcfs, mf, wf), (got, ms, ws) = out["fcfs"], out["slo"]
    bad = [rid for rid in got if got[rid] != fcfs.get(rid)]
    if bad or len(got) + sum(ms["slo"]["shed"].values()) != len(fcfs):
        fail(f"slo: requests {bad} differ from FCFS; served {len(got)}, "
             f"shed {ms['slo']['shed']} of {len(fcfs)}")
    if not (ms["sched"]["preempted"] and ms["sched"]["shed"]):
        fail(f"slo: the run must evict and shed: {ms['sched']}")
    if not ms["slo"]["attained"]["interactive"] > \
            mf["slo"]["attained"]["interactive"]:
        fail(f"slo: interactive attainment {ms['slo']['attained']} is no "
             f"better than FCFS's {mf['slo']['attained']}")
    print(f"serve slo bf16: {len(got)} served streams == FCFS streams; "
          + json.dumps({"fcfs": {"ticks": mf["ticks"], "wall_s": wf,
                                 "preempted": mf["sched"]["preempted"],
                                 "attained": mf["slo"]["attained"]},
                        "slo": {"ticks": ms["ticks"], "wall_s": ws,
                                "preempted": ms["sched"]["preempted"],
                                **ms["slo"]}}), flush=True)
    torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# phase 4: disaggregated serving (the control plane)
# ----------------------------------------------------------------------
def _tensor_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def _mean(xs) -> float:
    return sum(xs) / len(xs) if xs else 0.0


def disagg_run(pa, eng, cfg, trace, topo, router, spec_k, tag):
    """One run of ``trace`` (clock "tick") on ``topo`` = (P, D) cells over
    ``eng``'s weights (only pools and the mailbox are new; cells of
    ``eng.ctx``'s TP size, sharing its stacked weights), gated: zero
    quiets and fences on the handoff queue, and on the router and every
    pool queue under ``router="amo"``; signals == pages > 0, waits ==
    tickets; every cell's pool whole after the run with no table left;
    the paged launches, zeroed just before, = n_layers x the steps summed
    over the cells (verify windows through the prefill body), the other
    dtype's bodies never.  Each topology tick is timed to a synchronize.
    Returns (numbers, streams, launches by (kernel, dtype))."""
    from repro_torch.serve import DisaggEngine, TrafficConfig, make_requests

    class Timed(DisaggEngine):
        """Times each topology tick to a synchronize, and notes whether
        it issued a handoff ticket."""

        def tick(self, now=0.0):
            n0 = self.handoff["handoff_tickets"]
            t0 = time.monotonic()
            super().tick(now)
            torch.cuda.synchronize()
            ticks.append(((time.monotonic() - t0) * 1e3,
                          self.handoff["handoff_tickets"] > n0))

    dev = eng.device
    name = f"{topo[0]}+{topo[1]} {router}" + (f" k={spec_k}" if spec_k
                                               else "") + (
        f" tp={eng.ctx.tp_size}" if eng.ctx.tp_size > 1 else "")
    ticks = []                       # (wall ms, carried a handoff)
    gc.collect()                     # earlier runs' pools and mailboxes
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    d = Timed(eng.exec.params, cfg, spec_scfg(eng) if spec_k else eng.scfg,
              ctx=eng.ctx, device=dev, n_prefill=topo[0], n_decode=topo[1],
              router=router)
    reqs = make_requests(TrafficConfig(vocab=cfg.vocab, **trace))
    pa.reset_launches()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    done = d.run(reqs, clock="tick")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(pa.LAUNCHES_BY_DTYPE)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    m = d.metrics()
    hs, steps = m["handoff"], m["steps"]
    if len(done) != len(reqs) or any(len(r.out) != r.max_new for r in done):
        fail(f"disagg {tag} {name}: {len(done)} of {len(reqs)} requests "
             f"finished whole")
    want = {k: 0 for k in launches}
    want[("paged_prefill_attention", tag)] = cfg.n_layers * (
        steps["prefill"] + steps["verify"])
    want[("paged_decode_attention", tag)] = cfg.n_layers * steps["decode"]
    if launches != want:
        fail(f"disagg {tag} {name}: launches {launches} != n_layers x the "
             f"cells' steps {steps}: {want}")
    pool_q = [p.queue_stats() for p in d.pools]
    if (hs["handoff_quiets"] or hs["router_quiets"]
            or any(q["quiets"] or q["fences"] for q in pool_q)
            or not hs["handoff_signals"] == hs["handoff_pages"] > 0
            or hs["handoff_waits"] != hs["handoff_tickets"]):
        fail(f"disagg {tag} {name}: handoff counters {hs}")
    for c, e in zip(d.cells, d.engines):
        if e.kv.n_free() != e.kv.n_pages - 1 - e.kv.pinned_pages \
                or e.kv.tables:
            fail(f"disagg {tag} {name}: cell {c.cell}'s pool is not whole: "
                 f"{e.kv.n_free()} free of {e.kv.n_pages - 1}, tables "
                 f"{sorted(e.kv.tables)}")
    mail = d.hq.state["kv_mail"]
    row_bytes = mail[0, 0].numel() * mail.element_size()
    hand = [ms for ms, h in ticks if h]
    rest = [ms for ms, h in ticks if not h]
    out = {"ticks": m["ticks"], "steps": steps,
           "tokens_out": m["tokens_out"], "wall_s": wall,
           "tok_s": m["tokens_out"] / wall,
           "ttft_p50_ticks": m["ttft_p50_s"],
           "ttft_p99_ticks": m["ttft_p99_s"],
           "itl_p50_ticks": m["decode_p50_s"],
           "itl_p99_ticks": m["decode_p99_s"],
           **{k: hs[k] for k in ("handoff_tickets", "handoff_pages",
                                 "handoff_deferred", "handoff_signals",
                                 "handoff_waits", "handoff_quiets",
                                 "router_amos", "router_quiets", "steals",
                                 "alloc_cas_retries")},
           "handoff_bytes": hs["handoff_pages"] * row_bytes,
           "page_row_bytes": row_bytes, "peak_gb": peak,
           "tick_ms_handoff": _mean(hand), "ticks_handoff": len(hand),
           "tick_ms_no_handoff": _mean(rest), "ticks_no_handoff": len(rest)}
    print(f"serve disagg {tag} {name}: " + json.dumps(out), flush=True)
    del d
    torch.cuda.empty_cache()
    return out, streams_of(done), launches


def profile_disagg(eng, cfg, trace) -> None:
    """Ten profiled ticks of 2+2 ``host`` cells on the trace, every
    request submitted at tick 0: device time by kind, the tickets each
    tick issued, and every memcpy the profiler saw by direction.  Fails
    unless the window issues a ticket and holds no host<->device memcpy
    of a page row's size or more: a handoff moves KV by device copies
    only."""
    import tempfile

    from repro_torch.serve import DisaggEngine, TrafficConfig, make_requests

    gc.collect()
    d = DisaggEngine(eng.exec.params, cfg, eng.scfg, device=eng.device,
                     n_prefill=2, n_decode=2, router="host")
    for r in make_requests(TrafficConfig(vocab=cfg.vocab, **trace)):
        d.submit(r)
    mail = d.hq.state["kv_mail"]
    row_bytes = mail[0, 0].numel() * mail.element_size()
    tickets = []

    def run():
        for t in range(DISAGG_PROFILE_TICKS):
            n0 = d.handoff["handoff_tickets"]
            d.tick(t)
            tickets.append(d.handoff["handoff_tickets"] - n0)

    keep = []
    window = _profiled(run, keep=keep)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "disagg_trace.json")
        keep[0].export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    copies: dict = {}
    for e in events:
        nm = str(e.get("name", ""))
        if not nm.startswith("Memcpy"):
            continue
        kind = next((k for k in ("HtoD", "DtoH", "DtoD") if k in nm), nm)
        nbytes = e.get("args", {}).get("bytes")
        if nbytes is None and kind in ("HtoD", "DtoH"):
            fail(f"disagg profile: the trace gives no size for {nm}")
        c = copies.setdefault(kind,
                              {"count": 0, "bytes": 0, "max_bytes": 0})
        c["count"] += 1
        c["bytes"] += int(nbytes or 0)
        c["max_bytes"] = max(c["max_bytes"], int(nbytes or 0))
    big = {k: c["max_bytes"] for k, c in copies.items()
           if k in ("HtoD", "DtoH") and c["max_bytes"] >= row_bytes}
    if not sum(tickets) or big:
        fail(f"disagg profile: tickets per tick {tickets}; host<->device "
             f"copies of >= {row_bytes} bytes: {big}")
    print("profile disagg 2+2 host: " + json.dumps(
        {"tickets_per_tick": tickets, "page_row_bytes": row_bytes,
         "memcpy": copies, "window": window}), flush=True)
    del d
    torch.cuda.empty_cache()


def serve_disagg_bf16(pa, eng, cfg) -> dict:
    """Full-width bf16 disaggregated serving on the same weights:
    ``TICK_TRACE`` on clock "tick" colocated (the yardstick of phases 8
    and 10), then on ``DISAGG_RUNS``, each
    gated (``disagg_run``); 1+1 ``amo`` must give 1+1 ``host``'s streams
    bit for bit, and each 2+2 peak stays below twice the weights (the
    cells share them).  Each run's streams that leave the colocated ones
    are printed with the colocated path's top-2 margin at the first
    divergence (not gated: bits cross kernel bodies in bf16).  Then ten
    profiled 2+2 ticks (``profile_disagg``).  Returns the launches summed
    over the disagg runs, the colocated run's streams and its peak
    memory in GB (the tensor-parallel stage's yardstick)."""
    from repro_torch.serve import TrafficConfig, make_requests

    dcfg = TrafficConfig(vocab=cfg.vocab, **TICK_TRACE)
    weights_gb = _tensor_bytes(eng.exec.params) / 1e9
    eng.reset_metrics()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(eng.device)
    t0 = time.monotonic()
    colo = streams_of(eng.run(make_requests(dcfg), clock="tick"))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    colo_peak = torch.cuda.max_memory_allocated(eng.device) / 1e9
    mc = eng.metrics()
    print("serve disagg bf16 colocated (clock tick): " + json.dumps(
        {"ticks": mc["ticks"], "steps": mc["steps"], "wall_s": wall,
         "peak_gb": colo_peak,
         "tok_s": mc["tokens_out"] / wall,
         "ttft_p50_ticks": mc["ttft_p50_s"],
         "ttft_p99_ticks": mc["ttft_p99_s"],
         "itl_p50_ticks": mc["decode_p50_s"],
         "itl_p99_ticks": mc["decode_p99_s"]}), flush=True)
    total: dict = {}
    res = {}
    for topo, router, k in DISAGG_RUNS:
        out, streams, launches = disagg_run(pa, eng, cfg, TICK_TRACE, topo,
                                            router, k, "bf16")
        res[(topo, router, k)] = (out, streams)
        for key, n in launches.items():
            total[key] = total.get(key, 0) + n
        if topo == (2, 2) and not out["peak_gb"] < 2 * weights_gb:
            fail(f"disagg bf16 {topo} {router}: peak "
                 f"{out['peak_gb']:.2f} GB is not below twice the "
                 f"{weights_gb:.2f} GB of weights")
        same, text = margin_text(eng, cfg, make_requests(dcfg), streams,
                                 colo, labels=("disagg", "colocated"))
        print(f"serve disagg bf16 {topo[0]}+{topo[1]} {router} k={k}: "
              f"{same} of {len(colo)} streams == colocated"
              + (f"; first divergences: {text}" if text else ""),
              flush=True)
    host, amo = (res[((1, 1), r, 0)][1] for r in ("host", "amo"))
    if amo != host:
        fail(f"disagg bf16: 1+1 amo streams differ from 1+1 host at "
             f"{divergences(amo, host)}")
    peaks = [o["peak_gb"] for (t, _, _), (o, _) in res.items()
             if t == (2, 2)]
    print(f"serve disagg bf16: 1+1 amo streams == 1+1 host streams; "
          f"weights {weights_gb:.2f} GB, 2+2 peaks {peaks} GB", flush=True)
    profile_disagg(eng, cfg, SERVE_TRACE)
    return total, colo, colo_peak


def serve_disagg_f32(pa, eng, cfg, base_streams) -> dict:
    """Full-width f32 disaggregated serving on the f32 weights:
    ``DISAGG_RUNS_F32`` on the f32 trace, each gated (``disagg_run``),
    whose streams must equal the f32 colocated run's; a stream may leave
    it only where the colocated path's top-2 margin at the first
    divergence is below ``F32_NEAR_TIE`` x |top logit| (printed), and
    the 2+2 peak stays below twice the weights.  Returns the launches
    summed over the runs."""
    from repro_torch.serve import TrafficConfig, make_requests

    reqs = make_requests(TrafficConfig(vocab=cfg.vocab, **SERVE_TRACE_F32))
    prompts = {r.rid: r.prompt for r in reqs}
    weights_gb = _tensor_bytes(eng.exec.params) / 1e9
    total: dict = {}
    for topo, router, k in DISAGG_RUNS_F32:
        out, streams, launches = disagg_run(pa, eng, cfg, SERVE_TRACE_F32,
                                            topo, router, k, "f32")
        for key, n in launches.items():
            total[key] = total.get(key, 0) + n
        if topo == (2, 2) and not out["peak_gb"] < 2 * weights_gb:
            fail(f"disagg f32 {topo}: peak {out['peak_gb']:.2f} GB is not "
                 f"below twice the {weights_gb:.2f} GB of weights")
        div = divergences(streams, base_streams)
        ties = []
        if div:
            margins = decode_margins(eng, cfg, [
                (prompts[rid], base_streams[rid], j) for rid, j in div])
            for (rid, j), (mg, top, val) in zip(div, margins):
                if not mg < F32_NEAR_TIE * abs(val):
                    fail(f"disagg f32 {topo}: request {rid} output {j} "
                         f"{streams[rid][j:j + 3]} vs colocated "
                         f"{base_streams[rid][j:j + 3]} at a top-2 margin "
                         f"{mg:.6g} of top-1 logit {val:.6g}: no near-tie")
                ties.append({"rid": rid, "output": j, "margin": mg,
                             "top_logit": val, "top_token": top})
        print(f"serve disagg f32 {topo[0]}+{topo[1]} {router}: "
              f"{len(base_streams) - len(div)} of {len(base_streams)} "
              f"streams == colocated f32; near-ties {json.dumps(ties)}; "
              f"weights {weights_gb:.2f} GB", flush=True)
    return total


def first_step_logits(eng, cfg, reqs) -> None:
    """The first prefill chunk (64 tokens of each of the trace's first 8
    prompts) and the first decode step after it, through the engine's
    own trunks on its weights, once with the kernels and once with the
    plain versions, each on a fresh pool: the logits must agree within
    LOGIT_TOL x max |logit|.  (Full-width streams are not compared: a
    greedy near-tie in f32 may flip with the summation order.)"""
    import dataclasses

    from repro_torch.models import embed as emb
    from repro_torch.parallel import tp_of
    from repro_torch.serve import engine as se

    scfg, params = eng.scfg, eng.exec.params
    dev = eng.device
    c = scfg.prefill_chunk
    prompts = [r.prompt[:c] for r in reqs[:scfg.max_batch]]
    b = len(prompts)
    ids = torch.zeros((b, c), dtype=torch.int32)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = torch.tensor(p, dtype=torch.int32)
    ids = ids.to(dev)
    n_tok = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                         device=dev)
    start = torch.zeros_like(n_tok)
    need = -(-(c + 1) // scfg.page_tokens)          # the window + one token
    bt = torch.zeros((b, scfg.table_slots), dtype=torch.int32)
    bt[:, :need] = 1 + torch.arange(b * need, dtype=torch.int32).view(b, need)
    bt = bt.to(dev)
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    rows = torch.arange(b, device=dev)
    got = {}
    for impl in ("kernel", "ref"):
        sc2 = dataclasses.replace(scfg, attn_impl=impl)
        pool = eng.exec.init_pool()
        x, pool = se._make_window_forward(cfg, sc2)(params, pool, ids, start,
                                                    n_tok, bt)
        lp = emb.lm_head_logits(head, x[rows, n_tok.long() - 1]).float()
        # both paths decode the token the kernel path's logits pick
        tok = (lp if impl == "kernel" else got["kernel"][0]).argmax(-1)
        x, pool = se._make_decode_forward(cfg, sc2)(
            params, pool, tok.to(torch.int32), n_tok, bt, n_tok + 1)
        got[impl] = (lp, emb.lm_head_logits(head, x).float())
        del pool, x
    torch.cuda.synchronize()
    errs = []
    for i, step in enumerate(("prefill", "decode")):
        k, r = got["kernel"][i], got["ref"][i]
        if not (torch.isfinite(k).all() and k.shape == (b, cfg.vocab)):
            fail(f"serve f32: first {step} logits not finite of shape "
                 f"({b}, {cfg.vocab})")
        err = (k - r).abs().max().item()
        scale = r.abs().max().item()
        if not err <= LOGIT_TOL * scale:
            fail(f"serve f32: first {step} logits, kernel vs plain max err "
                 f"{err} > {LOGIT_TOL} x max |logit| {scale}")
        errs.append(f"{step} {err:.3e} (max |logit| {scale:.3f})")
    print(f"serve f32: first-step logits, kernel path vs plain path, max "
          f"|diff|: {', '.join(errs)}; tol {LOGIT_TOL} x max |logit|",
          flush=True)


def _kind(name: str) -> str:
    if "paged_" in name:
        return "paged attention (ours)"
    if "flash_fwd_" in name:
        return "flash attention (ours)"
    # ours are (anonymous namespace)::copy_kernel / ::combine_kernel<...>;
    # PyTorch's own copies are ...::direct_copy_kernel_cuda
    if "::copy_kernel(" in name or "::copy_bulk_kernel(" in name:
        return "copy engine (ours)"
    if "::combine_kernel<" in name:
        return "combine (ours)"
    low = name.lower()
    if any(t in low for t in ("gemm", "nvjet", "xmma", "cutlass")):
        return "matmul (cuBLAS)"
    if "sort" in low:
        return "sort (sampler, MoE router)"
    return "elementwise/reduce/copy"


def _profiled(run, top: int = 6, keep=None) -> dict:
    """Run ``run()`` under the profiler: device time by kernel and by
    kind, and the device's busy share of the wall time (a lower bound:
    the profiler adds host time).  ``keep``, a list, receives the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    if keep is not None:
        keep.append(prof)
    kinds: dict = {}
    per: list = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us <= 0 or e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        per.append((us, e.count, e.key))
        kinds[_kind(e.key)] = kinds.get(_kind(e.key), 0.0) + us
    busy_ms = sum(kinds.values()) / 1e3
    return {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms,
        "by_kind_ms": {k: v / 1e3 for k, v in sorted(
            kinds.items(), key=lambda kv: -kv[1])},
        "top_kernels": [{"name": n[:80], "calls": c, "ms": us / 1e3}
                        for us, c, n in sorted(per, reverse=True)[:top]],
    }


def _window(eng, tick, n_ticks, top: int = 6):
    """Profile up to ``n_ticks`` engine ticks (see ``_profiled``)."""
    steps0 = dict(eng.steps)

    def run():
        nonlocal tick
        for _ in range(n_ticks):
            if not eng.sched.has_work():
                break
            eng.tick(tick)
            tick += 1

    out = _profiled(run, top)
    return tick, {"steps": {k: eng.steps[k] - steps0[k] for k in steps0},
                  **out}


def _prefill_all(eng, tick):
    """Tick until no request is prefilling; returns the next tick."""
    while eng.sched.has_work() and any(
            r.is_prefilling() for r in [*eng.sched.running,
                                        *eng.sched.waiting]):
        eng.tick(tick)
        tick += 1
    return tick


def profile_serve(eng, reqs) -> None:
    """Where the time of the same trace goes, on the same engine: all
    requests submitted at once, then ten profiled ticks while prompts
    are prefilling (prefill + decode steps) and ten once every prompt is
    done (decode steps only)."""
    eng.reset_metrics()
    for r in reqs:
        eng.submit(r)
    tick, mixed = _window(eng, 0, 10)
    tick, decode = _window(eng, _prefill_all(eng, tick), 10)
    while eng.sched.has_work():
        eng.tick(tick)
        tick += 1
    print("profile: " + json.dumps({"prefill_and_decode_ticks": mixed,
                                    "decode_only_ticks": decode}),
          flush=True)


def profile_verify(eng, reqs) -> None:
    """The speculative engine's counterpart of the decode-only window:
    ``reqs`` submitted at once, prefilled, then ten profiled ticks of
    verify windows only."""
    eng.reset_metrics()
    for r in reqs:
        eng.submit(r)
    _, window = _window(eng, _prefill_all(eng, 0), 10)
    print(f"profile spec k={SPEC_K}: " + json.dumps(
        {"verify_only_ticks": window}), flush=True)


def serve_smoke_streams(pa, dev, arch):
    """Kernel vs plain attention on ``arch``'s smoke config in f32 on the
    card: identical greedy streams (the reference's acceptance bar),
    without and with speculation (k = 2, n-gram), and with prefix
    keeping, where the same prompts served again resume from migrated
    pages.  The smoke configs' capacity (MoE) drops nothing, so no
    stream may move.  Through the kernels each run launches n_layers x
    its steps, through the plain versions none."""
    from repro_torch.launch.serve import build_engine
    from repro_torch.serve import Request

    t0 = time.monotonic()
    prompts = [list(range(3, 9)), list(range(4, 10)), [7, 3, 99, 12]]
    streams = {}
    modes = (("plain", {}), ("spec", dict(spec_k=2)),
             ("prefix", dict(prefix_keep=True)))
    for mode, kw in modes:
        for impl in ("kernel", "ref"):
            eng, cfg = build_engine(arch, config="smoke", dtype="f32",
                                    device=dev, page_tokens=4, n_pages=32,
                                    max_batch=3, prefill_chunk=3,
                                    attn_impl=impl, seed=0, **kw)
            pa.reset_launches()
            done = eng.run([Request(rid=i, prompt=p, max_new=5)
                            for i, p in enumerate(prompts)], clock="tick")
            got = {r.rid: list(r.out) for r in done}
            if mode == "prefix":
                again = [r for r in eng.run(
                    [Request(rid=10 + i, prompt=p, max_new=5)
                     for i, p in enumerate(prompts)], clock="tick")
                    if r.rid >= 10]
                if eng.kv.stats["prefix_hits"] < 2 or \
                        {r.rid - 10: list(r.out) for r in again} != got:
                    fail(f"{arch} smoke prefix resume ({impl}): hits "
                         f"{eng.kv.stats['prefix_hits']}, streams "
                         f"{[r.out for r in again]} vs {got}")
            torch.cuda.synchronize()
            n = cfg.n_layers if impl == "kernel" else 0
            want_launches = {
                "paged_decode_attention": n * eng.steps["decode"],
                "paged_prefill_attention": n * (eng.steps["prefill"]
                                                + eng.steps["verify"])}
            if dict(pa.LAUNCHES) != want_launches:
                fail(f"{arch} smoke {mode} ({impl}): launches "
                     f"{dict(pa.LAUNCHES)}, want {want_launches}")
            if mode == "spec" and not eng.metrics()["spec"]["verify_ticks"]:
                fail(f"{arch} smoke spec run verified nothing")
            streams[mode, impl] = got
    want = streams["plain", "ref"]
    bad = {k: v for k, v in streams.items() if v != want}
    if bad:
        fail(f"{arch} smoke streams differ from the plain non-spec run "
             f"{want}: {bad}")
    print(f"serve smoke f32 ({arch}): kernel streams == plain streams, with "
          f"and without speculation (k=2) and after prefix resumes, "
          f"launches = n_layers x steps {want}; "
          f"{time.monotonic() - t0:.1f} s", flush=True)


# ----------------------------------------------------------------------
# phase 4: MoE serving
# ----------------------------------------------------------------------
def moe_engine(arch, dtype, dev, n_pages, ctx=None):
    """``build_engine`` on ``arch``: weights drawn on ``dev`` from seed 0;
    with a ``ctx`` at tp > 1 stacked by ``shard_for_tp`` (the experts as
    views, the column splits replacing their sources: the tp = 1 dict
    is dropped once stacked).  Prints the parameter count, the bytes the
    weights take and the build's peak."""
    import gc

    from repro_torch.launch.serve import build_engine
    from repro_torch.parallel import tp_of
    from repro_torch.train.tree import leaves

    gc.collect()                 # earlier engines' cycles, then their memory
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    t0 = time.monotonic()
    eng, cfg = build_engine(arch, config="full", dtype=dtype, device=dev,
                            page_tokens=P, n_pages=n_pages, max_batch=B,
                            prefill_chunk=WINDOW, attn_impl="kernel", seed=0,
                            ctx=ctx)
    gc.collect()
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in leaves(eng.exec.params))
    w_bytes = sum(t.numel() * t.element_size()
                  for t in leaves(eng.exec.params))
    m = cfg.moe
    tp = (f"at TP {ctx.tp_size} ({ctx.backend}, {ctx.moe_dispatch}; experts "
          f"{tuple(eng.exec.params['blocks']['mlp']['wu'].shape)}, a view), "
          if tp_of(ctx) > 1 else "")
    print(f"serve moe: {cfg.name}, {tp}{cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv}, head_dim "
          f"{cfg.head_dim}, {m.num_experts} experts (padded "
          f"{m.experts_padded(1)}) top-{m.top_k} of ff {m.expert_ff}, "
          f"shared ff {m.shared_ff}, capacity factor {m.capacity_factor}; "
          f"{n_par / 1e9:.3f} B parameters, {dtype} weights "
          f"{w_bytes / 1e9:.2f} GB, pool {n_pages} pages "
          f"{eng.pool.numel() * eng.pool.element_size() / 1e9:.3f} GB, on "
          f"the card {torch.cuda.memory_allocated(dev) / 1e9:.2f} GB (held "
          f"before {held / 1e9:.2f}, build peak "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f}), init "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    return eng, cfg


def moe_serve_run(pa, eng, cfg, trace, tag, record: bool = False) -> tuple:
    """One run of the seeded ``trace`` on ``eng`` (clock "tick": arrivals
    by tick, so a second run has the same batches and, under the
    capacity's drops, the same streams); the paged-attention launches,
    zeroed just before, must equal n_layers x the run's prefill and
    decode steps.  With ``record`` the routing and the draws are
    recorded (``MoeRecorder``).  Returns (streams, launches by (kernel,
    dtype), metrics with wall seconds, tok/s and peak memory, the
    recorded events or None)."""
    from repro_torch.serve import TrafficConfig, make_requests

    reqs = make_requests(TrafficConfig(vocab=cfg.vocab, **trace))
    eng.reset_metrics()
    torch.cuda.reset_peak_memory_stats(eng.device)
    pa.reset_launches()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with (MoeRecorder(cfg) if record else contextlib.nullcontext()) as rec:
        done = eng.run(reqs, clock="tick")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(pa.LAUNCHES_BY_DTYPE)
    m = eng.metrics()
    if len(done) != len(reqs):
        fail(f"serve {tag}: {len(done)} of {len(reqs)} requests finished")
    for r in done:
        if len(r.out) != r.max_new or not all(0 <= t < cfg.vocab
                                              for t in r.out):
            fail(f"serve {tag}: request {r.rid} produced {r.out}")
    dt = "bf16" if eng.scfg.dtype == torch.bfloat16 else "f32"
    want = {k: 0 for k in launches}
    want[("paged_prefill_attention", dt)] = \
        cfg.n_layers * m["steps"]["prefill"]
    want[("paged_decode_attention", dt)] = cfg.n_layers * m["steps"]["decode"]
    if launches != want or not (m["steps"]["prefill"] and
                                m["steps"]["decode"]):
        fail(f"serve {tag}: kernel launches {launches} != n_layers x steps "
             f"{want}")
    out = {"wall_s": wall, "tok_s": m["tokens_out"] / wall,
           "tokens_out": m["tokens_out"], "ticks": m["ticks"],
           "steps": m["steps"], "sched": m["sched"],
           "peak_memory_gb": torch.cuda.max_memory_allocated(eng.device)
           / 1e9}
    print(f"serve {tag}: {len(done)} requests, prompts "
          f"{min(r.n_prompt for r in reqs)}-{max(r.n_prompt for r in reqs)} "
          f"tokens, launches prefill "
          f"{launches[('paged_prefill_attention', dt)]} decode "
          f"{launches[('paged_decode_attention', dt)]} ({cfg.n_layers} x "
          f"steps); " + json.dumps(out), flush=True)
    return streams_of(done), launches, out, rec.done() if record else None


def moe_decode_profile(eng, cfg, trace) -> dict:
    """Ten profiled decode-only ticks of ``trace`` (submitted at once,
    prefilled first), and the decode step's device time beside its
    weight-read bound: every weight but the embedding table is read once
    a step (the expert products run over every expert, empty or not, and
    the head reads its whole table), at the data sheet's HBM rate."""
    from repro_torch.launch import roofline
    from repro_torch.serve import TrafficConfig, make_requests
    from repro_torch.train.tree import leaves

    eng.reset_metrics()
    for r in make_requests(TrafficConfig(vocab=cfg.vocab, **trace)):
        eng.submit(r)
    _, win = _window(eng, _prefill_all(eng, 0), 10, top=16)
    w_bytes = sum(t.numel() * t.element_size()
                  for t in leaves(eng.exec.params))
    table = eng.exec.params["embed"]["table"]
    step_bytes = w_bytes - table.numel() * table.element_size()
    n = win["steps"]["decode"]
    if not n or win["steps"]["prefill"]:
        fail(f"serve moe profile: steps {win['steps']} are not decode only")
    step_ms = win["device_busy_ms"] / n
    bound_ms = step_bytes / roofline.HBM_BW * 1e3
    out = {"decode_only_ticks": win, "decode_step_device_ms": step_ms,
           "weight_bytes_per_step": step_bytes,
           "weight_read_bound_ms": bound_ms,
           "bound_share": bound_ms / step_ms,
           "decode_step_wall_ms": win["wall_ms"] / n}
    print(f"profile {cfg.name}: " + json.dumps(out), flush=True)
    return out


class MoeRecorder:
    """While open, every routing call of ``models.mlp`` (``route`` and the
    capacity slots ``positions_in_expert``) and every token draw of
    ``serve.sampling.sample_tokens`` is recorded in call
    order, as ``events``: a route event holds the top-k experts of each
    row (n, k), which of them kept a slot, the gap between the k-th
    and (k+1)-th gate as a share of the k-th and the router's address
    (which layer routed); a sample event the slots'
    request ids, generated positions, top-2 logits and argmax.  At
    tp > 1 PE 0's view is kept and every PE's experts are checked equal
    to it (the router is replicated: routing is the same on every PE);
    with ``per_pe`` (the alltoall route in training, where each PE
    routes its own sequence shard) every PE's rows are kept instead,
    PE-major, each gap from its PE's router, and nothing is checked
    across PEs.  Nothing syncs while open; ``done()`` moves the events
    to the host and fails if any PE routed otherwise."""

    def __init__(self, cfg, per_pe: bool = False):
        self.cfg = cfg
        self.per_pe = per_pe
        self.events: list = []
        self._alike: list = []

    def __enter__(self):
        from repro_torch.models import mlp
        from repro_torch.parallel import tp_of
        from repro_torch.serve import sampling

        m = self.cfg.moe
        k = m.top_k
        self._mods = (mlp, sampling)
        self._orig = (mlp.route, mlp.positions_in_expert,
                      sampling.sample_tokens)
        route0, slots0, sample0 = self._orig

        def route(router_w, xt, cfg_):
            gate_k, idx_k = route0(router_w, xt, cfg_)
            idx = idx_k.reshape((-1,) + idx_k.shape[-2:])
            # the router, or each PE's copy (tp, d, E)
            w = router_w.reshape((-1,) + router_w.shape[-2:])
            if self.per_pe:
                xs = xt.reshape(w.shape[0], -1, xt.shape[-1])
                logits = torch.bmm(xs, w.to(xs.dtype)).flatten(0, 1).float()
                idx = idx.reshape(1, -1, k)
            else:
                self._alike.append((idx == idx[:1]).all())
                x0 = xt.reshape((-1,) + xt.shape[-2:])[0]
                logits = (x0 @ w[0].to(x0.dtype)).float()
            logits[:, m.num_experts:] = -1e30
            top = torch.softmax(logits, -1).topk(k + 1, dim=-1).values
            self.events.append({                  # a copy, not a view
                "kind": "route", "idx": idx[0].clone(),
                "gap": (top[:, k - 1] - top[:, k]) / top[:, k - 1],
                "router": router_w.data_ptr()})
            return gate_k, idx_k

        def slots(idx_k, n_experts):
            pos = slots0(idx_k, n_experts)
            n = idx_k.shape[-2]
            cap = int(n * k * m.capacity_factor / n_experts) + 1
            kept = pos.reshape(-1, pos.shape[-1]) < cap
            self.events[-1]["kept"] = (kept.reshape(-1, k) if self.per_pe
                                       else kept[0].view(n, k))
            return pos

        def sample(logits, state, pos, n_candidates=8, ctx=None):
            full = logits if tp_of(ctx) == 1 else \
                logits.movedim(0, -2).flatten(-2)
            top = full.float().topk(2, dim=-1)
            self.events.append({
                "kind": "sample",
                "rid": torch.as_tensor(state["rid"]).clone(),
                "pos": pos.clone(), "top": top.values,
                "tok": top.indices[..., 0].clone()})
            return sample0(logits, state, pos, n_candidates=n_candidates,
                           ctx=ctx)

        mlp.route, mlp.positions_in_expert = route, slots
        sampling.sample_tokens = sample
        return self

    def __exit__(self, *exc):
        mlp, sampling = self._mods
        mlp.route, mlp.positions_in_expert, sampling.sample_tokens = \
            self._orig
        return False

    def done(self) -> list:
        if self._alike and not torch.stack(self._alike).all().item():
            fail(f"moe {self.cfg.name}: the PEs of a TP group routed a "
                 f"token to other experts")
        self.events = [{k: v.cpu() if torch.is_tensor(v) else v
                        for k, v in e.items()} for e in self.events]
        self._alike = []
        return self.events


def route_sets(ev, n_exp: int) -> tuple:
    """A route event's (rows, experts) membership of the top-k set and of
    the kept pairs."""
    idx = ev["idx"].long()
    n = idx.shape[0]
    member = torch.zeros((n, n_exp), dtype=torch.bool).scatter_(1, idx, True)
    kept = torch.zeros((n, n_exp), dtype=torch.bool).scatter_(
        1, idx, ev["kept"])
    return member, kept


def moe_first_step(eng, cfg, reqs, impl: str, tok=None) -> dict:
    """The first prefill chunk (64 tokens of each of the trace's first 8
    prompts) and the first decode step after it, through ``eng``'s own
    trunks and weights (its ctx: tp = 1 or the stacked TP layout) with
    the ``impl`` attention on a fresh pool, the routing recorded
    (``MoeRecorder``).  The decode step feeds ``tok`` (default: this
    window's argmax).  Returns the full-vocab logits of both steps, their
    route events, the fed tokens and the window's geometry."""
    from repro_torch.models import embed as emb
    from repro_torch.parallel import tp_of
    from repro_torch.serve import engine as se

    scfg, params, dev, ctx = eng.scfg, eng.exec.params, eng.device, eng.ctx
    c = scfg.prefill_chunk
    prompts = [r.prompt[:c] for r in reqs[:scfg.max_batch]]
    b = len(prompts)
    ids = torch.zeros((b, c), dtype=torch.int32)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = torch.tensor(p, dtype=torch.int32)
    ids = ids.to(dev)
    n_tok = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                         device=dev)
    start = torch.zeros_like(n_tok)
    need = -(-(c + 1) // scfg.page_tokens)
    bt = torch.zeros((b, scfg.table_slots), dtype=torch.int32)
    bt[:, :need] = 1 + torch.arange(b * need, dtype=torch.int32).view(b, need)
    bt = bt.to(dev)
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    rows = torch.arange(b, device=dev)

    def full(x):
        # at tp > 1 the vocab shards (tp, b, V/tp) side by side
        lg = emb.lm_head_logits(head, x, ctx).float()
        return lg if tp_of(ctx) == 1 else lg.movedim(0, -2).flatten(-2)

    sc2 = dataclasses.replace(scfg, attn_impl=impl)
    pool = eng.exec.init_pool()
    with MoeRecorder(cfg) as rw:
        x, pool = se._make_window_forward(cfg, sc2, ctx)(
            params, pool, ids, start, n_tok, bt)
        lp = full(x[..., rows, n_tok.long() - 1, :])
    tok = lp.argmax(-1) if tok is None else tok
    with MoeRecorder(cfg) as rd:
        x, pool = se._make_decode_forward(cfg, sc2, ctx)(
            params, pool, tok.to(torch.int32), n_tok, bt, n_tok + 1)
        ld = full(x)
    del pool, x
    torch.cuda.synchronize()
    return {"prefill": lp, "decode": ld, "win": rw.done(), "dec": rd.done(),
            "tok": tok, "b": b, "c": c, "n_tok": n_tok.cpu(),
            "dtype": scfg.dtype}


def moe_logits_verdict(cfg, got: dict, want: dict, gated: bool,
                       labels=("kernel", "plain")) -> dict:
    """Two ``moe_first_step`` results (``got`` against ``want``) by the
    routing-aware rule.  A flip is a row whose top-k set or kept set
    differs between the two; it reaches later layers of its row, later
    rows of its sequence (attention) and, in the decode step, its
    sequence.  Rows no flip reaches must give logits within LOGIT_TOL x
    max |logit| of ``want``'s, every flip no earlier flip reached must
    change the top-k set at a near-tie (the relative gap below
    MOE_TIE), and every keep-only flip no earlier flip reached must
    follow a set change at an earlier row of its layer (the capacity
    cascade); with ``gated`` False (bf16) this is printed, not
    checked."""
    m, tie = cfg.moe, MOE_TIE[want["dtype"]]
    n_exp = m.experts_padded(1)
    b, c, n_tok = want["b"], want["c"], want["n_tok"]
    a_lab, b_lab = labels

    def walk(kr, rr, shape, tainted):
        """Flips layer by layer; returns (tainted rows after the last
        layer, flips [(layer, row, set changed, gap, reached before)])."""
        flips = []
        for li, (a, z) in enumerate(zip(kr, rr)):
            (ma, ka), (mz, kz) = route_sets(a, n_exp), route_sets(z, n_exp)
            setf = (ma != mz).any(1).view(shape)
            fl = setf | (ka != kz).any(1).view(shape)
            rows_ = torch.nonzero(fl.flatten()).flatten().tolist()
            if rows_:
                sf, gp, tn = (t.flatten().tolist()
                              for t in (setf, z["gap"], tainted))
                flips += [(li, r, sf[r], gp[r], tn[r]) for r in rows_]
            tainted = tainted | fl
            if len(shape) == 2:       # attention: later rows of the sequence
                tainted = tainted.cumsum(1) > 0
        return tainted, flips

    out = {"tie": tie, "gated": gated}
    t_win, f_win = walk(got["win"], want["win"], (b, c),
                        torch.zeros((b, c), dtype=torch.bool))
    t_dec, f_dec = walk(got["dec"], want["dec"], (b,), t_win.any(1))
    rows = torch.arange(b)
    held = {"prefill": ~t_win[rows, n_tok.long() - 1], "decode": ~t_dec}
    for step, flips in (("prefill", f_win), ("decode", f_dec)):
        kl, rl = got[step].cpu(), want[step].cpu()
        if not (torch.isfinite(kl).all() and kl.shape == (b, cfg.vocab)):
            fail(f"moe {cfg.name}: first {step} logits not finite of shape "
                 f"({b}, {cfg.vocab})")
        hold = held[step]
        scale = rl.abs().max().item()
        err = ((kl - rl).abs().max(1).values[hold].max().item()
               if hold.any() else float("nan"))
        # flips no earlier flip reached: a changed top-k set there can come
        # only from the two computations' rounding, so it must sit at a
        # near-tie; a changed keep mask alone is the capacity cascade of a
        # set change at an earlier row of the same layer
        new = [f for f in flips if not f[4]]
        roots = [f for f in new if f[2]]
        cascades = [f for f in new if not f[2]]
        bad = [f for f in roots if not f[3] < tie] + [
            f for f in cascades
            if not any(g[0] == f[0] and g[2] and g[1] < f[1] for g in flips)]
        if new and not new[0][2]:
            bad.insert(0, new[0])
        out[step] = {
            "flips": len(flips), "held_rows": int(hold.sum()),
            "max_err_held": err, "max_logit": scale,
            "roots": [{"layer": f[0], "row": f[1], "gap": f[3]}
                      for f in roots],
            "cascades": [{"layer": f[0], "row": f[1]} for f in cascades]}
        print(f"moe {cfg.name} {step} ({a_lab} vs {b_lab}): {len(flips)} "
              f"flips (row = sequence"
              f"{f' x {c} + position' if step == 'prefill' else ''}); "
              f"{len(roots)} set flips no earlier flip reached (layer:row:"
              f"gap) " + " ".join(f"{f[0]}:{f[1]}:{f[3]:.2e}" for f in roots)
              + f"; {len(cascades)} keep-only cascades (layer:row) "
              + " ".join(f"{f[0]}:{f[1]}" for f in cascades)
              + f"; held rows {int(hold.sum())} of {b}, max |{a_lab} - "
              f"{b_lab}| {err:.3e} (tol {LOGIT_TOL} x max |logit| "
              f"{scale:.3f}); near-tie bar {tie:.3e}"
              f"{'' if gated else ' (printed, not gated)'}", flush=True)
        if not gated:
            continue
        if not hold.any():
            fail(f"moe {cfg.name} {step}: every row reached by a flip")
        if not err <= LOGIT_TOL * scale:
            fail(f"moe {cfg.name} {step}: held rows' logits max err {err} > "
                 f"{LOGIT_TOL} x max |logit| {scale}")
        if bad:
            fail(f"moe {cfg.name} {step}: flips that are neither a near-tie "
                 f"(gap < {tie}) nor the cascade of an earlier row's set "
                 f"change, (layer, row, set changed, gap): "
                 f"{[f[:4] for f in bad]}")
    return out


def moe_routing_compare(eng, cfg, reqs, gated: bool) -> dict:
    """The first step through the kernels and through the plain versions
    on ``eng`` (``moe_first_step``), held by the routing-aware rule
    (``moe_logits_verdict``).  Returns the kernel side, which phase 11
    holds its TP runs to."""
    kern = moe_first_step(eng, cfg, reqs, "kernel")
    plain = moe_first_step(eng, cfg, reqs, "ref", tok=kern["tok"])
    moe_logits_verdict(cfg, kern, plain, gated)
    return kern


def serve_moe_bf16(pa, dev) -> tuple:
    """qwen3-moe-30b-a3b in bf16: ``MOE_TRACE`` served twice on the same
    engine (the same streams both times; the second recorded), launches
    = n_layers x steps; a profiled decode-only window against the
    weight-read bound;
    the routing comparison, printed.  Returns the counted run's launches
    by (kernel, dtype) and what phase 11 holds its TP runs to: the
    streams, the recorded run, the first step through the kernels, the
    peak."""
    from repro_torch.serve import TrafficConfig, make_requests

    t0 = time.monotonic()
    eng, cfg = moe_engine(MOE_BF16, "bf16", dev, 512)
    # warm-up on a throwaway trace (cuBLAS handles, first launches)
    eng.run(make_requests(TrafficConfig(vocab=cfg.vocab, **WARMUP_TRACE)),
            clock="tick")
    first, launches, out, _ = moe_serve_run(pa, eng, cfg, MOE_TRACE,
                                            "moe bf16")
    again, _, _, rec = moe_serve_run(pa, eng, cfg, MOE_TRACE,
                                     "moe bf16 again", record=True)
    if again != first:
        bad = sorted(r for r in first if again.get(r) != first[r])
        fail(f"serve moe bf16: the second run's streams differ (requests "
             f"{bad})")
    print("serve moe bf16: the second run gave the same streams", flush=True)
    moe_decode_profile(eng, cfg, MOE_TRACE)
    reqs = make_requests(TrafficConfig(vocab=cfg.vocab, **MOE_TRACE))
    kern = moe_routing_compare(eng, cfg, reqs, gated=False)
    del eng
    torch.cuda.empty_cache()
    print(f"serve moe bf16 stage: {time.monotonic() - t0:.1f} s", flush=True)
    return launches, {"streams": first, "rec": rec, "first": kern,
                      "peak_gb": out["peak_memory_gb"], "run": out}


def serve_moe_f32(pa, dev) -> tuple:
    """qwen2-moe-a2.7b in f32, the reference's serving dtype: the routing
    comparison, gated; then the seeded f32 trace, recorded, launches =
    n_layers x steps.  Returns the run's launches by (kernel, dtype) and
    what phase 11 holds its TP runs to (as ``serve_moe_bf16``)."""
    from repro_torch.serve import TrafficConfig, make_requests

    t0 = time.monotonic()
    eng, cfg = moe_engine(MOE_F32, "f32", dev, MOE_F32_PAGES)
    reqs = make_requests(TrafficConfig(vocab=cfg.vocab, **MOE_TRACE))
    kern = moe_routing_compare(eng, cfg, reqs, gated=True)
    streams, launches, out, rec = moe_serve_run(
        pa, eng, cfg, MOE_TRACE, "moe f32", record=True)
    del eng
    torch.cuda.empty_cache()
    print(f"serve moe f32 stage: {time.monotonic() - t0:.1f} s", flush=True)
    return launches, {"streams": streams, "rec": rec, "first": kern,
                      "peak_gb": out["peak_memory_gb"], "run": out}


# ----------------------------------------------------------------------
# phase 5: comm
# ----------------------------------------------------------------------
def comm_phase(sc, rc, dev, out_path=None) -> dict:
    """The comm path, 8 PEs on the card, through comm_bench (which checks
    every cell it times); returns the kernels' launch counts on the main
    path, the communicator calls."""
    from repro_torch.launch import comm_bench as cb

    t0 = time.monotonic()
    reps = COMM_REPS
    results = cb.schedule_rows(dev, cb.SIZES, reps, quiet=True)
    sc.reset_launches()
    rc.reset_launches()
    torch.cuda.synchronize()
    brows, checks = cb.backend_rows(dev, cb.SIZES, reps, quiet=True)
    torch.cuda.synchronize()
    launches = {"copy_blocked": sc.LAUNCHES["copy_blocked"],
                "combine_blocked": rc.LAUNCHES["combine_blocked"]}
    by_payload = dict(sc.LAUNCHES_BY_PAYLOAD)
    results += brows + cb.copy_rows(dev, cb.COPY_SIZES, reps, quiet=True)
    bench = cb.assemble(dev, results, checks, cb.SIZES, cb.COPY_SIZES, reps)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(bench, f, indent=1)
    if any(c["copy_launches"] != c["expected_launches"] for c in checks):
        fail("comm: copy launches differ from the staged rounds")
    # each (op, size) ran once checked, then 2 warm-up and ``reps`` timed
    # calls per backend: only the pallas calls launch the copy kernel
    staged = sum(c["copy_launches"] for c in checks)
    if launches["copy_blocked"] == 0 or \
            launches["copy_blocked"] != staged * (1 + 2 + reps):
        fail(f"comm: copy launches {launches['copy_blocked']} on the path "
             f"!= staged rounds {staged} x {1 + 2 + reps} calls")
    if launches["combine_blocked"]:
        fail(f"comm: the combine kernel ran {launches['combine_blocked']} "
             "times; no collective calls it")
    if sum(by_payload.values()) != launches["copy_blocked"]:
        fail(f"comm: copy launches by payload {by_payload} do not add up to "
             f"{launches['copy_blocked']}")
    print("comm copy launches by staged payload (bytes, dtype, variant): "
          + json.dumps(sorted([*k, n] for k, n in by_payload.items())),
          flush=True)
    rows = {(r["op"], r["algo"], r["nbytes"]): r for r in bench["results"]}
    for op in cb.COMM_OPS:
        cells = []
        for nb in sorted({r["nbytes"] for r in bench["results"]
                          if r["op"] == op}):
            algo = next(c["algo"] for c in bench["checks"]
                        if c["op"] == op and c["nbytes"] == nb)
            per = " ".join(
                f"{b} {rows[(op, 'backend:' + b, nb)]['us_per_call']:.1f}us/"
                f"{rows[(op, 'backend:' + b, nb)]['bytes_per_s'] / 1e9:.2f}GB/s"
                for b in ("xla", "posh", "pallas"))
            cells.append(f"{nb}B[{algo}] {per}")
        print(f"comm {op}: " + " | ".join(cells), flush=True)
    per = " | ".join(
        f"{r['algo']}@{r['nbytes']}B {r['us_per_call']:.1f}us/"
        f"{r['bytes_per_s'] / 1e9:.2f}GB/s"
        for r in bench["results"] if r["op"] == "symm_copy"
        and r["nbytes"] == max(cb.COPY_SIZES))
    print(f"comm symm_copy: {per}", flush=True)
    comm_profile(dev)
    print(f"comm: {len(bench['results'])} rows, {len(bench['checks'])} "
          f"checked cells (pallas == posh bit for bit, posh vs xla, "
          f"{staged} staged kernel copies == staged rounds), launches "
          f"{launches}, tuned thresholds {bench['tuned_thresholds']}, "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    return launches, by_payload


def comm_profile(dev) -> None:
    """Where a psum's time goes: 10 calls of each backend at 64 KiB and
    64 MiB per PE under the profiler (after the launch counters are
    read, so these calls count nowhere)."""
    from repro_torch import comm as C

    out = {}
    g = torch.Generator(device=dev).manual_seed(7)
    for nbytes in (64 << 10, 64 << 20):
        x = torch.randn((N_PE, nbytes // 4), generator=g, device=dev)
        for b in ("xla", "posh", "pallas"):
            c = C.make_communicator("pe", size=N_PE, backend=b)
            c.psum(x)
            out[f"psum {b} {nbytes}B x10"] = _profiled(
                lambda: [c.psum(x) for _ in range(10)], top=3)
        del x
    print("comm profile: " + json.dumps(out), flush=True)


# ----------------------------------------------------------------------
# phase 6: train
# ----------------------------------------------------------------------
def train_full(fa, dev) -> tuple:
    """Full-width gemma-2b training steps through build_trainer; returns
    the flash launches of the measured steps and step 0's metrics."""
    from repro_torch.launch.train import build_trainer

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    tr = build_trainer(TRAIN["arch"], global_batch=TRAIN["global_batch"],
                       microbatches=TRAIN["microbatches"], device=dev, seed=0)
    torch.cuda.synchronize()
    cfg = tr.cfg
    n_params = sum(p.numel() for p in tr.state["params"]["embed"].values())
    n_params += sum(p.numel() for blk in tr.state["params"]["blocks"]
                    for sub in blk.values() for p in sub.values())
    print(f"train: {cfg.name} full width, {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv}, head_dim "
          f"{cfg.head_dim}, d_ff {cfg.d_ff} ({cfg.act}), vocab {cfg.vocab}, "
          f"{n_params / 1e9:.3f} B params f32; seq {cfg.max_seq}, global "
          f"batch {TRAIN['global_batch']} in {TRAIN['microbatches']} "
          f"microbatches; state {torch.cuda.memory_allocated() / 1e9:.2f} "
          f"GB, init {time.monotonic() - t0:.1f} s", flush=True)
    tokens = TRAIN["global_batch"] * cfg.max_seq
    fa.reset_launches()
    torch.cuda.synchronize()
    steps = []
    for s in range(TRAIN["steps"]):
        m = tr.step(s)
        m["tokens_per_s"] = tokens / m["seconds"]
        m["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        steps.append(m)
        print(f"train step {s}: loss {m['loss']:.4f} grad_norm "
              f"{m['grad_norm']:.4f} {m['seconds']:.2f} s "
              f"{m['tokens_per_s']:.0f} tok/s peak "
              f"{m['max_memory_allocated_gb']:.2f} GB", flush=True)
    torch.cuda.synchronize()
    launches = fa.LAUNCHES["flash_attention"]
    want = cfg.n_layers * TRAIN["microbatches"] * TRAIN["steps"] * 2
    if launches != want:
        fail(f"train: flash launches {launches} != predicted {want} "
             f"(layers x microbatches x steps x 2 under remat)")
    if not all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
               for m in steps):
        fail(f"train: non-finite loss or grad norm {steps}")
    # 0.02-scale tied embeddings give near-uniform logits: ln(vocab) at init
    if not abs(steps[0]["loss"] - math.log(cfg.vocab)) < 0.5:
        fail(f"train: initial loss {steps[0]['loss']} is not near "
             f"ln(vocab) = {math.log(cfg.vocab):.3f}")
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    if peak >= 80.0:
        fail(f"train: peak memory {peak:.2f} GB")
    print("train metrics: " + json.dumps({
        "steps": steps, "flash_launches": launches,
        "flash_launches_predicted": want, "peak_memory_gb": peak}),
        flush=True)
    del tr
    torch.cuda.empty_cache()
    return launches, steps[0]


def train_smoke_parity(dev) -> None:
    """Smoke configs in f32 on the card: 3 steps with the flash kernel
    and with the plain forward give the same losses (rtol 1e-5: the two
    forwards differ only by summation order)."""
    from repro_torch.launch.train import build_trainer

    for arch in ("gemma-2b", "qwen3-8b"):
        losses = {}
        for impl in ("kernel", "ref"):
            tr = build_trainer(arch, smoke=True, microbatches=2, device=dev,
                               attn_impl=impl)
            losses[impl] = [tr.step(s)["loss"] for s in range(3)]
        worst = max(abs(a - b) / abs(b)
                    for a, b in zip(losses["kernel"], losses["ref"]))
        if not worst <= 1e-5:
            fail(f"train smoke {arch}: kernel losses {losses['kernel']} vs "
                 f"plain {losses['ref']}")
        print(f"train smoke {arch} f32: kernel losses {losses['kernel']} == "
              f"plain {losses['ref']} (max rel diff {worst:.2e})", flush=True)


# ----------------------------------------------------------------------
# phase 8: weight hot-swap
# ----------------------------------------------------------------------
def _watch_swap(eng) -> dict:
    """Wrap ``eng.tick`` (a ServeEngine or a DisaggEngine): each tick's
    wall to a synchronize of the serving stream (a batch's copy is on
    it, ahead of the tick's forwards) and its kind — "stream" (a batch
    is issued at its head), "flip" or "none" — and, at the flip, the
    tokens each request of ``rec["reqs"]`` had emitted before that tick;
    and each cell's ``set_params``, recording the tick it was called
    on."""
    rec = {"ticks": [], "flip_tick": None, "pre": None, "set_params": [],
           "reqs": []}
    tick = eng.tick

    def timed(now=0.0):
        streaming = eng.swap_in_flight()
        before = {r.rid: len(r.out) for r in rec["reqs"]}
        t0 = time.monotonic()
        tick(now)
        torch.cuda.current_stream(eng.device).synchronize()
        ms = (time.monotonic() - t0) * 1e3
        kind = ("flip" if streaming and not eng.swap_in_flight()
                else "stream" if streaming else "none")
        rec["ticks"].append((ms, kind))
        if kind == "flip":
            rec["flip_tick"], rec["pre"] = eng.ticks, before

    eng.tick = timed
    for e in getattr(eng, "engines", [eng]):
        def record(params, set_params=e.exec.set_params):
            rec["set_params"].append(eng.ticks)
            set_params(params)

        e.exec.set_params = record
    return rec


def swap_run(pa, eng, cfg, draw, base, name):
    """Serve a warm-up trace, then ``TICK_TRACE`` on clock "tick" on
    ``eng`` without a swap (its tick walls are the baseline), then again
    while ``draw()`` streams in (``SWAP``'s
    rows), then ``SWAP_TRACE_POST`` on the new weights,
    gated: one flip, after the first tick, every cell's weights switched
    on it; the stream batches + 1 ticks long (10-99 at full width); zero
    fences and quiets on the swap queue and on the handoff queue;
    ``swap_bytes`` the packed payload, its rows pinned on the host; every
    token emitted before the flip equal to ``base``'s (the old weights'
    streams); every request served whole; the paged launches, zeroed
    just before the swap run, n_layers x its and the post trace's steps
    in bf16; the peak under ``SWAP_PEAK_GB``.  A streaming tick's wall is
    compared with the same tick of the baseline run (the same schedule:
    the trace's work differs from tick to tick).  Returns (numbers,
    post-flip streams, launches by (kernel, dtype))."""
    from repro_torch.serve import TrafficConfig, make_requests

    dev = eng.device
    cells = getattr(eng, "cells", None)
    topo = (0, 0) if cells is None else (
        sum(c.role == "prefill" for c in cells),
        sum(c.role == "decode" for c in cells))
    rec = _watch_swap(eng)
    for trace in (WARMUP_TRACE, TICK_TRACE):
        rec["ticks"].clear()
        eng.reset_metrics()
        eng.run(make_requests(TrafficConfig(vocab=cfg.vocab, **trace)),
                clock="tick")
    base_ms = [ms for ms, _ in rec["ticks"]]
    rec["ticks"].clear()
    eng.reset_metrics()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    eng.begin_hot_swap(draw(), **SWAP)
    torch.cuda.synchronize()
    begin_s = time.monotonic() - t0
    st = eng._swap
    payload, batches = st.stats["bytes"], st.stats["batches"]
    pinned = st._rows.is_pinned()
    del st
    reqs = rec["reqs"] = make_requests(TrafficConfig(vocab=cfg.vocab,
                                                     **TICK_TRACE))
    pa.reset_launches()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    done = eng.run(reqs, clock="tick")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    m = eng.metrics()
    sw, steps = m["swap"], dict(m["steps"])
    quiets = eng.stats()["handoff_quiets"] if cells else 0
    eng.reset_metrics()
    post = eng.run(make_requests(TrafficConfig(vocab=cfg.vocab,
                                               **SWAP_TRACE_POST)),
                   clock="tick")
    torch.cuda.synchronize()
    launches = dict(pa.LAUNCHES_BY_DTYPE)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    for k, v in eng.metrics()["steps"].items():
        steps[k] += v
    if cells:
        quiets += eng.stats()["handoff_quiets"]

    bad = []
    if (sw["flips"] != 1 or sw["swap_extra_quiets"]
            or sw["swap_bytes"] != payload or sw["swap_batches"] != batches
            or sw["swap_ticks"] != batches + 1 or not pinned):
        bad.append(f"swap stats {sw} (payload {payload}, {batches} "
                   f"batches, rows pinned {pinned})")
    if cfg.n_layers == 36 and not 10 <= sw["swap_ticks"] < 100:
        bad.append(f"{sw['swap_ticks']} swap ticks at full width")
    n_cells = len(cells) if cells else 1
    if not (rec["flip_tick"] or 0) > 1 \
            or rec["set_params"] != [rec["flip_tick"]] * n_cells:
        bad.append(f"flip at tick {rec['flip_tick']}, set_params on ticks "
                   f"{rec['set_params']} for {n_cells} cells")
    if quiets:
        bad.append(f"{quiets} handoff quiets")
    if len(done) != len(reqs) or any(len(r.out) != r.max_new for r in done):
        bad.append("the trace was not served whole")
    pre = rec["pre"] or {}
    pre_bad = [r.rid for r in reqs
               if r.out[:pre.get(r.rid, 0)] != base[r.rid][:pre.get(r.rid, 0)]]
    if pre_bad:
        bad.append(f"pre-flip tokens differ from the old weights' streams "
                   f"for requests {pre_bad}")
    want = {k: 0 for k in launches}
    want[("paged_prefill_attention", "bf16")] = cfg.n_layers * (
        steps["prefill"] + steps["verify"])
    want[("paged_decode_attention", "bf16")] = cfg.n_layers * steps["decode"]
    if launches != want:
        bad.append(f"launches {launches} != n_layers x steps {want}")
    if not peak < SWAP_PEAK_GB[topo]:
        bad.append(f"peak {peak:.2f} GB >= {SWAP_PEAK_GB[topo]} GB")
    if len(base_ms) < m["ticks"]:
        bad.append(f"the baseline run took {len(base_ms)} ticks, the swap "
                   f"run {m['ticks']}")
    if bad:
        fail(f"hot-swap {name}: " + "; ".join(bad))

    swap_ms = [ms for ms, _ in rec["ticks"][:m["ticks"]]]
    kinds = [k for _, k in rec["ticks"][:m["ticks"]]]

    def paired(kind):
        """(mean wall of the ticks of ``kind``, mean of the same ticks in
        the baseline run)"""
        idx = [i for i, k in enumerate(kinds) if k == kind]
        return (_mean([swap_ms[i] for i in idx]),
                _mean([base_ms[i] for i in idx]))

    out = {"layers": cfg.n_layers, "payload_bytes": payload,
           "row_bytes": SWAP["row_bytes"], "chunk_rows": SWAP["chunk_rows"],
           "batches": batches, "begin_s": begin_s,
           "swap_ticks": sw["swap_ticks"], "flip_tick": rec["flip_tick"],
           "flips": sw["flips"], "swap_extra_quiets": sw["swap_extra_quiets"],
           "handoff_quiets": quiets, "ticks": m["ticks"], "steps": steps,
           "wall_s": wall, "tokens_out": m["tokens_out"],
           "tok_s": m["tokens_out"] / wall,
           "base_wall_s": sum(base_ms) / 1e3,
           "tick_ms_stream_vs_same_ticks_no_swap": paired("stream"),
           "tick_ms_flip_vs_same_tick_no_swap": paired("flip"),
           "tick_ms_after_flip_vs_same_ticks_no_swap": paired("none"),
           "pre_flip_tokens": sum(pre.values()),
           "finished_before_flip": sum(pre[r.rid] == r.max_new
                                       for r in reqs),
           "peak_gb": peak}
    print(f"hot-swap bf16 {name}: " + json.dumps(out), flush=True)
    return out, streams_of(post), launches


def swap_stage(pa, dev, base) -> dict:
    """Phase 8: weight hot-swap on full-width qwen3-8b in bf16, through
    the paged kernels.  Colocated on the serve stage's weights (seed 0,
    ``build_engine``), then 1+1 host cells on the same weights, both at
    36 layers, then 2+2 host cells at ``SWAP_2P2_LAYERS`` layers; each a
    gated ``swap_run``, whose post-flip streams must equal, bit for bit,
    a cold colocated engine's on the new weights (drawn again from
    ``SWAP_SEED``).  ``base`` is the serve stage's colocated tick-clock
    streams.  Returns the paged launches summed over the swap runs (the
    cold engines' are comparisons, not counted)."""
    from repro_torch.launch.serve import build_engine
    from repro_torch.models import lm
    from repro_torch.serve import (DisaggEngine, ServeEngine, TrafficConfig,
                                   make_requests)

    t_stage = time.monotonic()
    print(f"hot-swap: row_bytes {SWAP['row_bytes']}, chunk_rows "
          f"{SWAP['chunk_rows']} ({SWAP['row_bytes'] * SWAP['chunk_rows']} "
          f"bytes a tick)", flush=True)

    def draw(cfg, seed):
        return lambda: lm.init(torch.Generator(device=dev).manual_seed(seed),
                               cfg, dtype=torch.bfloat16, device=dev)

    def cold(cfg, scfg, trace, seed):
        gc.collect()
        torch.cuda.empty_cache()
        eng = ServeEngine(draw(cfg, seed)(), cfg, scfg, device=dev)
        return streams_of(eng.run(make_requests(TrafficConfig(
            vocab=cfg.vocab, **trace)), clock="tick"))

    total: dict = {}
    gc.collect()
    torch.cuda.empty_cache()
    eng, cfg = build_engine("qwen3-8b", config="full", dtype="bf16",
                            device=dev, page_tokens=P, n_pages=512,
                            max_batch=B, prefill_chunk=64,
                            attn_impl="kernel", seed=0)
    scfg = eng.scfg
    runs = []
    _, post, launches = swap_run(pa, eng, cfg, draw(cfg, SWAP_SEED), base,
                                 "colocated")
    runs.append(("colocated", post, launches))
    del eng
    want = cold(cfg, scfg, SWAP_TRACE_POST, SWAP_SEED)
    d = DisaggEngine(draw(cfg, 0)(), cfg, scfg, device=dev, n_prefill=1,
                     n_decode=1)
    _, post, launches = swap_run(pa, d, cfg, draw(cfg, SWAP_SEED), base,
                                 "1+1 host")
    runs.append(("1+1 host", post, launches))
    del d
    for name, post, _ in runs:
        if post != want:
            fail(f"hot-swap {name}: post-flip streams differ from the cold "
                 f"engine's at {divergences(post, want)}")
    print(f"hot-swap: colocated and 1+1 post-flip streams == a cold engine "
          f"on the new weights ({len(want)} streams)", flush=True)
    cfg2 = dataclasses.replace(cfg, n_layers=SWAP_2P2_LAYERS)
    base2 = cold(cfg2, scfg, TICK_TRACE, 0)
    want2 = cold(cfg2, scfg, SWAP_TRACE_POST, SWAP_SEED)
    d = DisaggEngine(draw(cfg2, 0)(), cfg2, scfg, device=dev, n_prefill=2,
                     n_decode=2)
    _, post, launches = swap_run(pa, d, cfg2, draw(cfg2, SWAP_SEED), base2,
                                 f"2+2 host ({SWAP_2P2_LAYERS} layers)")
    runs.append(("2+2 host", post, launches))
    del d
    if post != want2:
        fail(f"hot-swap 2+2: post-flip streams differ from the cold "
             f"engine's at {divergences(post, want2)}")
    for _, _, launches in runs:
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
    gc.collect()
    torch.cuda.empty_cache()
    print(f"hot-swap stage: {time.monotonic() - t_stage:.1f} s; launches "
          f"{total}", flush=True)
    return total


# ----------------------------------------------------------------------
# phase 9: checkpoint / restart
# ----------------------------------------------------------------------
def ckpt_stage(fa, dev) -> int:
    """Phase 9: checkpoint/restart of the single-card trainer, gemma-2b
    at its published width cut to ``CKPT["layers"]`` layers, f32, through
    the flash kernel.  ``CKPT["steps"]`` steps uninterrupted; then a new
    trainer (the same seed) through ``ft.run_with_restarts`` with a
    checkpoint every ``CKPT["every"]`` steps and a failure injected at
    step ``CKPT["fail_at"]``, which restores the newest checkpoint from
    disk and finishes ``CKPT["restart_steps"]``; then ``launch.train
    --resume`` on that directory to ``CKPT["steps"]``.  Gates: the
    restart restores step ``CKPT["every"]`` once; the resumed losses equal
    the uninterrupted run's within the gap between the uninterrupted
    run's first steps and their repeat in the restart run (0 on a
    deterministic card: then equal); the flash launches, zeroed just
    before the two runs, 2 x layers x microbatches x the steps they ran.
    Prints bytes written, save (snapshot, background write), load +
    sha256 seconds and the free disk before.  Deletes the directory.
    Returns the flash launches."""
    import shutil

    from repro_torch.ckpt import Checkpointer
    from repro_torch.ckpt import checkpoint as ckmod
    from repro_torch.ft import run_with_restarts
    from repro_torch.launch import train as launch
    from repro_torch.train import state_to_tree

    t_stage = time.monotonic()
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    os.makedirs(CKPT_DIR)
    free_gb = shutil.disk_usage(CKPT_DIR).free / 1e9
    kw = dict(global_batch=CKPT["global_batch"],
              microbatches=CKPT["microbatches"], device=dev, seed=0,
              n_layers=CKPT["layers"])

    def trainer():
        gc.collect()
        torch.cuda.empty_cache()
        return launch.build_trainer(CKPT["arch"], **kw)

    tr = trainer()
    cfg = tr.cfg
    state_gb = _tensor_bytes(state_to_tree(tr.state, device="meta")) / 1e9
    print(f"checkpoint: {cfg.name} d_model {cfg.d_model}, vocab {cfg.vocab}, "
          f"{cfg.n_layers} of 18 layers, f32 state {state_gb:.2f} GB; free "
          f"disk {free_gb:.1f} GB under {CKPT_DIR}", flush=True)
    if free_gb < 2.2 * state_gb:
        fail(f"checkpoint: {free_gb:.1f} GB free, two checkpoints need "
             f"{2 * state_gb:.1f} GB")
    whole = [tr.step(s) for s in range(CKPT["steps"])]
    del tr

    tr = trainer()
    ck = Checkpointer(CKPT_DIR, keep=3)
    times: dict = {"snapshot_s": [], "write_s": [], "load_sha256_s": []}
    write = ckmod.save_checkpoint

    def timed_write(*a, **k):
        t0 = time.monotonic()
        out = write(*a, **k)
        times["write_s"].append(time.monotonic() - t0)
        return out

    class TrainerCheckpointer:
        """``run_with_restarts``' checkpointer over the trainer: its state
        saved and restored in the reference's layout."""

        def save_async(self, step, state):
            t0 = time.monotonic()
            tr.save(ck, step)
            times["snapshot_s"].append(time.monotonic() - t0)

        def wait(self):
            ck.wait()

        def restore(self, state):
            t0 = time.monotonic()
            step = tr.restore(ck)
            torch.cuda.synchronize()
            times["load_sha256_s"].append(time.monotonic() - t0)
            return tr.state, step

    def make_step(attempt):
        return lambda state, sid: (tr.state, tr.step(sid))

    fa.reset_launches()
    ckmod.save_checkpoint = timed_write
    try:
        _, info = run_with_restarts(
            make_step, lambda attempt: tr.state, TrainerCheckpointer(),
            n_steps=CKPT["restart_steps"], ckpt_every=CKPT["every"],
            failure_schedule={CKPT["fail_at"]: RuntimeError(
                f"injected failure at step {CKPT['fail_at']}")})
    finally:
        ckmod.save_checkpoint = write
    ran = len(info["losses"])
    written = {d: sum(os.path.getsize(os.path.join(CKPT_DIR, d, f))
                      for f in os.listdir(os.path.join(CKPT_DIR, d)))
               for d in sorted(os.listdir(CKPT_DIR))}
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    resumed = launch.main([
        "--arch", CKPT["arch"], "--layers", str(CKPT["layers"]),
        "--steps", str(CKPT["steps"]),
        "--global-batch", str(CKPT["global_batch"]),
        "--microbatches", str(CKPT["microbatches"]),
        "--ckpt-dir", CKPT_DIR, "--ckpt-every", str(10 * CKPT["steps"]),
        "--resume"])
    resume_s = time.monotonic() - t0
    torch.cuda.synchronize()
    launches = fa.LAUNCHES["flash_attention"]
    shutil.rmtree(CKPT_DIR)

    every, fail_at = CKPT["every"], CKPT["fail_at"]
    losses = [m["loss"] for m in whole]
    repeat = info["losses"][:fail_at]               # before the failure
    after = info["losses"][fail_at:]                # restored at `every`
    got = after + [m["loss"] for m in resumed]
    want_steps = list(range(every, CKPT["restart_steps"])) + list(
        range(CKPT["restart_steps"], CKPT["steps"]))
    repeat_gap = max(abs(a - b) for a, b in zip(repeat, losses))
    gap = max(abs(a - losses[s]) for a, s in zip(got, want_steps))
    want_launches = 2 * cfg.n_layers * CKPT["microbatches"] * (
        ran + len(resumed))
    res = {"losses": losses, "restart_losses": info["losses"],
           "resumed_losses": [m["loss"] for m in resumed],
           "resumed_steps": [m["step"] for m in resumed],
           "restarts": info["restarts"], "final_step": info["final_step"],
           "max_gap": gap, "repeat_gap": repeat_gap,
           "bytes_written": written, "state_gb": state_gb,
           **times, "resume_run_s": resume_s, "free_disk_gb": free_gb,
           "flash_launches": launches,
           "flash_launches_predicted": want_launches,
           "step_s": [m["seconds"] for m in whole]}
    print("checkpoint metrics: " + json.dumps(res), flush=True)
    if (info["restarts"] != 1 or info["final_step"] != CKPT["restart_steps"]
            or len(times["load_sha256_s"]) != 1
            or set(written) != {f"step_{s}" for s in range(
                every, CKPT["restart_steps"] + 1, every)}
            or [m["step"] for m in resumed] != list(
                range(CKPT["restart_steps"] + 1, CKPT["steps"] + 1))):
        fail(f"checkpoint: restart bookkeeping {res}")
    if not all(math.isfinite(x) for x in losses + got):
        fail(f"checkpoint: non-finite losses {res}")
    if not gap <= repeat_gap:
        fail(f"checkpoint: resumed losses leave the uninterrupted run's by "
             f"{gap}, more than its repeat gap {repeat_gap}")
    if launches != want_launches:
        fail(f"checkpoint: flash launches {launches} != {want_launches}")
    print(f"checkpoint: resumed losses == uninterrupted (max gap {gap}, "
          f"repeat gap {repeat_gap}); stage {time.monotonic() - t_stage:.1f}"
          f" s", flush=True)
    return launches


# ----------------------------------------------------------------------
# phase 10: tensor-parallel serving on the stacked team
# ----------------------------------------------------------------------
def bf16_ulp(v: float) -> float:
    """One bf16 ulp at |v| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(max(abs(v), 1e-30))) - 7)


def near_tie_gate(eng, cfg, reqs, got: dict, want: dict, labels, tag,
                  got_logits=None) -> int:
    """Every stream of ``got`` that leaves ``want``'s is printed at its
    first divergence with ``want``'s top-2 margin there (``eng`` is
    ``want``'s computation, run over ``want``'s history).  It passes at a
    margin of at most one bf16 ulp of the top logit.  With
    ``got_logits`` (cases -> ``got``'s computation over them, as
    ``decode_logits``), both are run over that history,
    and it also passes when the gap from ``want``'s top logit to ``got``'s
    token is within DELTA, the largest gap between the two computations'
    logits there, and DELTA is at most NEAR_TIE_DELTA x |top logit|: two
    correct reductions in another order.  A dropped psum moves them by
    10-25% of |top| (``tp_faults``, measured in every run).  Fails on
    any other divergence.  Returns the number of divergences."""
    div = divergences(got, want)
    if not div:
        return 0
    prompts = {r.rid: r.prompt for r in reqs}
    cases = [(prompts[rid], want[rid], j) for rid, j in div]
    mine = decode_logits(eng, cfg, cases)
    other = got_logits(cases) if got_logits is not None \
        else [None] * len(cases)
    a, b = labels
    bad = []
    for (rid, j), lw, lg in zip(div, mine, other):
        lw = lw.float()
        vals, idx = lw.topk(2)
        mg, top_v = (vals[0] - vals[1]).item(), vals[0].item()
        ulp = bf16_ulp(top_v)
        text = (f"tp {tag}: request {rid} output {j}: {a} {got[rid][j:j + 3]}"
                f" vs {b} {want[rid][j:j + 3]}, top-2 margin {mg:.6g} (top-1 "
                f"{int(idx[0])} at {top_v:.6g}, one bf16 ulp {ulp:.6g})")
        ok = mg <= ulp
        if lg is not None:
            delta = (lw - lg.float()).abs().max().item()
            gap = top_v - lw[got[rid][j]].item() if j < len(got[rid]) else mg
            ok = ok or gap <= delta <= NEAR_TIE_DELTA * abs(top_v)
            text += (f"; {a}'s token {gap:.6g} below the top, the two "
                     f"computations' logits {delta:.6g} apart")
        print(text, flush=True)
        if not ok:
            bad.append((rid, j, mg))
    if bad:
        fail(f"tp {tag}: {a} leaves {b} beyond a near-tie (rid, output, "
             f"margin): {bad}")
    return len(div)


class DroppedPsum:
    """A communicator whose psum number ``drop`` of every ``period``
    calls returns its input unreduced: one layer's psum lost, the fault
    the near-tie rule must not pass."""

    def __init__(self, comm, drop: int, period: int):
        self.comm, self.drop, self.period, self.calls = comm, drop, period, 0

    def psum(self, x):
        k, self.calls = self.calls % self.period, self.calls + 1
        return x if k == self.drop else self.comm.psum(x)

    def __getattr__(self, name):
        return getattr(self.comm, name)


def tp_faults(cfg) -> dict:
    """The planted faults: name -> the psum dropped, as its index among
    a forward's 1 + 2 n_layers psums (the embedding's, then each
    layer's attention and MLP psums)."""
    mid = cfg.n_layers // 2
    return {f"layer {mid + 1}'s attention psum dropped": 1 + 2 * mid,
            f"layer {cfg.n_layers}'s MLP psum dropped": 2 * cfg.n_layers}


def faulty(eng, drop: int, n_layers: int):
    """``eng``'s computation with one psum of every forward dropped, as
    ``decode_logits`` takes an engine."""
    comm = DroppedPsum(eng.ctx.tp_comm, drop, 1 + 2 * n_layers)
    return types.SimpleNamespace(
        scfg=eng.scfg, exec=eng.exec, device=eng.device,
        ctx=dataclasses.replace(eng.ctx, tp_comm=comm))


def gap_share(got: list, want: list) -> float:
    """The largest gap between two computations' logits over cases, as a
    share of |top logit| of ``want``'s (the near-tie rule's measure)."""
    return max(((g.float() - w.float()).abs().max()
                / w.float().abs().max()).item() for g, w in zip(got, want))


def gap_cases(reqs, streams: dict) -> list:
    """Output TP_GAP_J of each request (at most 8) over ``streams``'s
    history: the fixed cases the gaps are read on."""
    return [(r.prompt, streams[r.rid], TP_GAP_J) for r in reqs[:B]]


@contextlib.contextmanager
def captured_calls(n_layers: int, picks: dict):
    """While open, the paged-attention calls of ``kernels.ops`` run as
    before and the arguments of the last layer's call of chosen steps
    are kept in the yielded dict: ``picks`` maps a name to (op, window
    rows or None, step), the op's calls (of that window) counted in
    steps of n_layers.  No copy and no sync: q, the tables and lengths
    are new tensors each step, the pages views of the live pool."""
    from repro_torch.kernels import ops

    names = ("paged_attention", "paged_prefill_attention")
    orig = {n: getattr(ops, n) for n in names}
    seen, got = {}, {}

    def wrap(name):
        def call(q, *args, **kw):
            for tag, (op, rows, step) in picks.items():
                if op == name and (rows is None or q.shape[1] == rows):
                    n = seen.get(tag, 0)
                    seen[tag] = n + 1
                    if n == step * n_layers + n_layers - 1:
                        got[tag] = (q,) + args
            return orig[name](q, *args, **kw)
        return call

    for n in names:
        setattr(ops, n, wrap(n))
    try:
        yield got
    finally:
        for n in names:
            setattr(ops, n, orig[n])


def tp_paged_parity(pa, got: dict, pool, replicas: int, tp: int,
                    tag: str) -> dict:
    """Each captured call of a TP step (``captured_calls``: decode, a
    64-row prefill window, a verify window) through the kernel and its
    plain version on the same inputs: the folded q (TP x R x B rows,
    hpr heads), the per-layer view of the stacked pool (its (R, TP,
    n_pages) axes merged) and the offset tables.  Gates: max |kernel -
    plain| within phase 3's DECODE_TOL / TOL, idle or padded rows
    exactly 0; every table row inside its PE's pages, the slots its
    live tokens use never that PE's page 0 (the null page), an idle
    row all null; then, every PE's page 0 overwritten in every layer,
    neither output moves a bit (no live row reads a null page, so what
    idle rows write there stays out of attention).  Returns the largest
    error by kernel."""
    n_pages = pool.shape[2]
    errs, runs = {}, {}
    for kind, args in sorted(got.items()):
        q, bt = args[0], args[3]
        decode = kind == "decode"
        name = "paged_decode_attention" if decode else \
            "paged_prefill_attention"
        kern, ref = getattr(pa, name), getattr(pa, name + "_ref")
        rows = bt.shape[0]
        n = rows // tp
        r = torch.arange(rows, device=bt.device)
        pe = ((r % n) // (n // replicas)) * tp + r // n
        low = (pe * n_pages)[:, None]
        if decode:
            used = (args[4].long() + P - 1) // P
        else:
            used = (args[4].long() + args[5].long() + P - 1) // P
        live = torch.arange(bt.shape[1], device=bt.device)[None] < \
            used[:, None]
        b64 = bt.long()
        null = b64 == low
        if not (((b64 >= low) & (b64 < low + n_pages)).all().item()
                and not (null & live).any().item()
                and null[used == 0].all().item()):
            fail(f"tp {tag} {kind}: a block table leaves its PE's pages, a "
                 f"live slot reads its null page or an idle row is not null")
        runs[kind] = (kern(*args), ref(*args))
        torch.cuda.synchronize()
        out, want = runs[kind]
        err = (out.float() - want.float()).abs().max().item()
        tol = (DECODE_TOL if decode else TOL)[q.dtype]
        idle = args[4] == 0 if decode else \
            torch.arange(q.shape[1], device=q.device)[None] >= \
            args[5][:, None]
        if not err <= tol or (idle.any().item()
                              and out[idle].abs().max().item() != 0.0):
            fail(f"tp {tag} {kind}: max |kernel - plain| {err} (tol {tol}) "
                 f"on q {tuple(q.shape)}, pages {tuple(args[1].shape)}, or "
                 f"an idle row is not exactly 0")
        errs[name] = max(errs.get(name, 0.0), err)
        n_live = int((args[4] if decode else args[5]).gt(0).sum())
        print(f"tp {tag} {kind} parity on the step's own inputs: q "
              f"{tuple(q.shape)} {str(q.dtype)[6:]} ({n_live} live rows), "
              f"pages "
              f"{tuple(args[1].shape)} (stride {args[1].stride(0)}), table "
              f"{tuple(bt.shape)} with offsets to {int(b64.max())}; max "
              f"|kernel - plain| {err:.3e} (tol {tol})", flush=True)
    pool[:, :, 0] = 100.0
    for kind, args in sorted(got.items()):
        name = "paged_decode_attention" if kind == "decode" else \
            "paged_prefill_attention"
        again = (getattr(pa, name)(*args), getattr(pa, name + "_ref")(*args))
        if not all(torch.equal(a, b) for a, b in zip(again, runs[kind])):
            fail(f"tp {tag} {kind}: writing every PE's page 0 moved the "
                 f"kernel's or the plain version's output")
    print(f"tp {tag}: every PE's page 0 overwritten, {sorted(got)} outputs "
          f"unchanged bit for bit", flush=True)
    return errs


def staged_copy_launches(comm) -> int:
    """The copy-kernel launches a pallas communicator's calls must have
    made: its calls by (op, per-PE bytes, dtype, algorithm), each priced
    by the schedules' rounds (``comm_bench.expected_copy_launches``; a
    top-k merge is one stacked all_gather)."""
    from repro_torch.launch import comm_bench as cb

    total = 0
    for (op, nbytes, dtype, algo), calls in comm.payload_stats().items():
        dt = getattr(torch, dtype)
        item = torch.empty((), dtype=dt).element_size()
        total += calls * cb.expected_copy_launches(
            "all_gather" if op == "top_k_merge" else op, algo, comm.size,
            nbytes // item, dt)
    return total


def psum_model_ms_per_step(comm, steps: int, dev) -> float:
    """A model of the ms a step spends in psums, from isolated timings:
    each psum payload the run made, timed alone on a fresh communicator
    of the same backend (``time_ms``) on random data, times its calls,
    over the run's steps.  Not a device time taken in the step."""
    from repro_torch.comm import make_communicator

    fresh = make_communicator("model", size=comm.size,
                              backend=comm.backend_name)
    total = 0.0
    for (op, nbytes, dtype, _), calls in comm.payload_stats().items():
        if op != "psum":
            continue
        dt = getattr(torch, dtype)
        item = torch.empty((), dtype=dt).element_size()
        x = torch.randn((comm.size, nbytes // item), device=dev).to(dt)
        total += calls * time_ms(lambda: fresh.psum(x), dev, iters=5)
    return total / max(steps, 1)


def tp_serve_run(pa, sc, eng, cfg, tag, picks=None, trace=TICK_TRACE,
                 record: bool = False) -> tuple:
    """``trace`` on clock "tick" on a TP engine, its launch counters and
    communicator stats zeroed just before, gated: every request whole;
    the paged bodies of the serving dtype n_layers x the prefill (and
    verify) and decode steps (one launch a layer for every PE), the
    other dtype's never; the copy kernel exactly the staged rounds of a
    pallas communicator's calls, under xla and posh never; a step's
    collectives: the embed's psum and, a layer, the attention's and the
    MLP's psums (a MoE block: the shared expert's, if any, and the routed
    experts' under the einsum dispatch, or two all_to_all under
    alltoall); one top-k merge.  ``picks`` keeps chosen paged calls'
    arguments (``captured_calls``), ``record`` the routing and draws
    (``MoeRecorder``).  Returns the numbers, the streams, the launches,
    the copy launches, the captured calls and the recorded events (or
    None)."""
    from repro_torch.serve import TrafficConfig, make_requests

    dev, comm = eng.device, eng.ctx.tp_comm
    reqs = make_requests(TrafficConfig(vocab=cfg.vocab, **trace))
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    eng.reset_metrics()
    comm.reset_stats()
    pa.reset_launches()
    sc.reset_launches()
    t0 = time.monotonic()
    with captured_calls(cfg.n_layers, picks or {}) as got, \
            (MoeRecorder(cfg) if record else contextlib.nullcontext()) as rec:
        done = eng.run(reqs, clock="tick")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(pa.LAUNCHES_BY_DTYPE)
    copies = sc.LAUNCHES["copy_blocked"]
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    m = eng.metrics()
    if len(done) != len(reqs) or any(len(r.out) != r.max_new or not all(
            0 <= t < cfg.vocab for t in r.out) for r in done):
        fail(f"tp {tag}: {len(done)} of {len(reqs)} requests finished whole")
    steps = m["steps"]
    dt = "bf16" if eng.scfg.dtype == torch.bfloat16 else "f32"
    want = {k: 0 for k in launches}
    want[("paged_prefill_attention", dt)] = cfg.n_layers * (
        steps["prefill"] + steps["verify"])
    want[("paged_decode_attention", dt)] = cfg.n_layers * steps["decode"]
    if launches != want or not steps["prefill"]:
        fail(f"tp {tag}: paged launches {launches} != n_layers x steps "
             f"{want}")
    staged = staged_copy_launches(comm) \
        if comm.backend_name == "pallas" else 0
    if copies != staged or (comm.backend_name == "pallas") != (copies > 0):
        fail(f"tp {tag}: copy-kernel launches {copies} != the staged rounds "
             f"of the communicator's calls {staged}")
    st, n_steps = comm.stats(), sum(steps.values())
    alltoall = bool(cfg.moe) and eng.ctx.moe_dispatch == "alltoall"
    mlp_psums = (bool(cfg.moe.shared_ff) + (not alltoall)) if cfg.moe else 1
    want_psums = n_steps * (1 + (1 + mlp_psums) * cfg.n_layers)
    want_a2a = n_steps * 2 * cfg.n_layers if alltoall else 0
    a2a = st.get("all_to_all", {})
    if st["psum"]["calls"] != want_psums or \
            a2a.get("calls", 0) != want_a2a or \
            st["top_k_merge"]["calls"] != n_steps:
        fail(f"tp {tag}: {st['psum']['calls']} psums / "
             f"{a2a.get('calls', 0)} all_to_all / "
             f"{st['top_k_merge']['calls']} merges over {n_steps} steps "
             f"(want {want_psums} / {want_a2a} / {n_steps})")
    out = {"backend": comm.backend_name, "tp": comm.size,
           "ticks": m["ticks"], "steps": steps,
           "tokens_out": m["tokens_out"], "wall_s": wall,
           "tok_s": m["tokens_out"] / wall, "peak_gb": peak,
           "psum_calls_per_step": {a: n / n_steps for a, n
                                   in st["psum"]["algos"].items()},
           "psum_bytes_per_step": st["psum"]["bytes"] / n_steps,
           "top_k_merge_algos": st["top_k_merge"]["algos"],
           "copy_launches": copies,
           "launches": {f"{k[0]}/{k[1]}": v for k, v in launches.items()
                        if v}}
    if cfg.moe:
        out["moe_dispatch"] = eng.ctx.moe_dispatch
        out["all_to_all_calls_per_step"] = {
            a: n / n_steps for a, n in a2a.get("algos", {}).items()}
    return (out, streams_of(done), launches, copies, got,
            rec.done() if record else None)


SMOKE_PROMPTS = [list(range(3, 11)), list(range(40, 46)), [7, 3, 99, 12, 55]]


def smoke_tp_engine(params, cfg, ctx, impl, dev, kv=None, my_pe=0, **kw):
    """A ServeEngine on a StackedExec of TP_SMOKE_REPLICAS replicas of
    ``ctx``'s TP group, the smoke serving geometry, ``impl`` attention,
    reading replica ``my_pe``; ``kv`` shares a cache."""
    from repro_torch.core.heap import SymmetricHeap
    from repro_torch.serve import (PagedKVCache, ServeConfig, ServeEngine,
                                   StackedExec)

    scfg = ServeConfig(page_tokens=4, n_pages=24, max_batch=3, max_seq=32,
                       prefill_chunk=3, attn_impl=impl, **kw)
    kv = kv or PagedKVCache(
        SymmetricHeap(("data", "model")), n_layers=cfg.n_layers,
        kv_heads=cfg.kv_per_rank(ctx.tp_size), head_dim=cfg.head_dim,
        n_pages=scfg.n_pages, page_tokens=scfg.page_tokens)
    ex = StackedExec(params, cfg, ctx, scfg, kv, dev,
                     replicas=TP_SMOKE_REPLICAS, my_pe=my_pe)
    return ServeEngine(params, cfg, scfg, ctx=ctx, exec_=ex, device=dev,
                       kv=kv, my_pe=my_pe)


def smoke_launches_ok(pa, cfg, steps: dict, impl: str, what: str,
                      total: dict) -> None:
    """A smoke run's paged launches, zeroed just before: n_layers x its
    steps through the kernels (verify windows through the prefill body),
    none through the plain versions; added into ``total`` by (kernel,
    dtype)."""
    torch.cuda.synchronize()
    n = cfg.n_layers if impl == "kernel" else 0
    want = {"paged_decode_attention": n * steps["decode"],
            "paged_prefill_attention": n * (steps["prefill"]
                                            + steps["verify"])}
    if dict(pa.LAUNCHES) != want:
        fail(f"tp smoke {what} ({impl}): launches {dict(pa.LAUNCHES)}, "
             f"want {want}")
    for k, v in pa.LAUNCHES_BY_DTYPE.items():
        total[k] = total.get(k, 0) + v


def tp_smoke_streams(pa, dev) -> dict:
    """The smoke qwen3-8b in f32 at TP 2 and 4 with two replicas, every
    backend: greedy streams through the kernels == through the plain
    versions, without and with speculation (k = 2) and after a prefix
    resume on replica 1 (pages migrated from replica 0, one put_nbi per
    TP rank and one quiet); each kernel run launches n_layers x its
    steps, each plain run none.  Returns the kernel runs' launches."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.parallel import ParallelCtx
    from repro_torch.serve import Request

    t0 = time.monotonic()
    cfg = configs.get_smoke("qwen3-8b")
    params = lm.init(torch.Generator(device=dev).manual_seed(0), cfg,
                     device=dev)
    prompts = SMOKE_PROMPTS
    prefix = list(range(3, 14))
    total: dict = {}

    def engine(ctx, impl, kv=None, my_pe=0, **kw):
        return smoke_tp_engine(params, cfg, ctx, impl, dev, kv, my_pe, **kw)

    def counted(eng, impl, what):
        smoke_launches_ok(pa, cfg, eng.steps, impl, what, total)

    for tp in TP_SMOKE:
        for backend in TP_BACKENDS:
            ctx = ParallelCtx(tp_size=tp, backend=backend)
            streams = {}
            for impl in ("kernel", "ref"):
                for mode, kw in (("plain", {}), ("spec", dict(spec_k=2))):
                    pa.reset_launches()
                    eng = engine(ctx, impl, **kw)
                    done = eng.run([Request(rid=i, prompt=list(p), max_new=6)
                                    for i, p in enumerate(prompts)],
                                   clock="tick")
                    counted(eng, impl, f"tp={tp} {backend} {mode}")
                    if mode == "spec" and not eng.steps["verify"]:
                        fail(f"tp smoke tp={tp} {backend}: spec verified "
                             f"nothing")
                    streams[mode, impl] = streams_of(done)
                pa.reset_launches()
                a = engine(ctx, impl, prefix_keep=True)
                first = a.run([Request(rid=0, prompt=list(prefix),
                                       max_new=6)], clock="tick")
                b = engine(ctx, impl, kv=a.kv, my_pe=1, prefix_keep=True)
                b.pool = a.pool
                b.submit(Request(rid=100, prompt=list(prefix), max_new=6))
                while b.sched.has_work():
                    b.tick()
                (res,) = b.finished
                if b.sched.stats["resumed"] != 1 or \
                        b.kv.stats["migrations"] < 2 or \
                        list(res.out) != list(first[0].out):
                    fail(f"tp smoke tp={tp} {backend} ({impl}): prefix "
                         f"resume on replica 1 {b.sched.stats} "
                         f"{b.kv.stats} {res.out} vs {first[0].out}")
                a.steps = {k: a.steps[k] + b.steps[k] for k in a.steps}
                counted(a, impl, f"tp={tp} {backend} prefix")
                streams["prefix", impl] = {0: list(first[0].out),
                                           100: list(res.out)}
            for mode in ("plain", "spec", "prefix"):
                if streams[mode, "kernel"] != streams[mode, "ref"]:
                    fail(f"tp smoke tp={tp} {backend} {mode}: kernel streams "
                         f"{streams[mode, 'kernel']} != plain "
                         f"{streams[mode, 'ref']}")
            if streams["spec", "ref"] != streams["plain", "ref"]:
                fail(f"tp smoke tp={tp} {backend}: spec streams differ from "
                     f"non-spec")
    print(f"tp smoke f32 (qwen3-8b-smoke, tp {TP_SMOKE}, "
          f"{TP_SMOKE_REPLICAS} replicas, {TP_BACKENDS}): kernel streams == "
          f"plain streams without and with spec (k=2) and after a replica "
          f"prefix resume; launches n_layers x steps; "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    return total


def tp_stage(pa, sc, dev, colo: dict, colo_peak: float) -> tuple:
    """Phase 10.  Full-width qwen3-8b in bf16 at TP 4 (one replica): the
    weights drawn from seed 0 as phase 4 draws them and stacked by
    ``shard_for_tp``; ``TICK_TRACE`` on clock "tick" under each backend
    (``tp_serve_run``); pallas == posh bit for bit; the paged kernels
    against their plain versions on the pallas run's own decode and
    64-row prefill inputs (``tp_paged_parity``); xla vs posh and TP 4
    (posh) vs phase 4's tp = 1 streams (``colo``; the tp = 1 side
    recomputed on the weights unstacked, ``weights.unshard``) held by the
    near-tie rule; the gap between those computations' logits on fixed
    cases below NEAR_TIE_DELTA and the gap of each planted fault
    (``tp_faults``) above it; every peak under TP_PEAK x ``colo_peak``;
    the modelled psum ms a step by backend.  Then spec k = 4 (n-gram)
    under posh: its streams vs the posh run's by the near-tie rule, the
    prefill body n_layers x (prefill + verify steps), the kernels
    against their plain versions on a verify window of the run.  Then,
    weights redrawn and stacked for TP 2, the colocated TP 2 run under
    posh (vs tp = 1 by the near-tie rule, its gap on the fixed cases
    below NEAR_TIE_DELTA) and 2+2 host cells of TP 2 on the one stacked
    dict (``disagg_run``'s gates), their streams vs the colocated TP 2
    run's by the near-tie rule.  Then the smoke configs
    (``tp_smoke_streams``).  Returns the phase's paged launches by
    (kernel, dtype), its copy-kernel launches and the largest error of
    each paged kernel on the TP steps' inputs."""
    from repro_torch.launch.serve import build_engine
    from repro_torch.parallel import ParallelCtx
    from repro_torch.serve import ServeEngine, TrafficConfig, make_requests
    from repro_torch.weights import unshard

    t0 = time.monotonic()
    total: dict = {}
    copies = 0

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    gc.collect()
    torch.cuda.empty_cache()
    eng, cfg = build_engine(
        "qwen3-8b", config="full", dtype="bf16", device=dev, page_tokens=P,
        n_pages=512, max_batch=B, prefill_chunk=64, attn_impl="kernel",
        seed=0, ctx=ParallelCtx(tp_size=TP_FULL, backend="xla"))
    params, scfg = eng.exec.params, eng.scfg
    del eng
    gc.collect()
    torch.cuda.synchronize()
    weights_gb = _tensor_bytes(params) / 1e9
    print(f"tp: qwen3-8b full width at TP {TP_FULL}, bf16 weights stacked "
          f"(TP, ...) {weights_gb:.2f} GB, {torch.cuda.memory_allocated() / 1e9:.2f}"
          f" GB allocated; init and stacking {time.monotonic() - t0:.1f} s",
          flush=True)
    reqs = make_requests(TrafficConfig(vocab=cfg.vocab, **TICK_TRACE))
    runs, streams = {}, {}
    eng = got = None
    for backend in TP_BACKENDS:
        eng = got = None              # the last backend's pool goes first
        gc.collect()
        torch.cuda.empty_cache()
        eng = ServeEngine(params, cfg, scfg, device=dev,
                          ctx=ParallelCtx(tp_size=TP_FULL, backend=backend))
        eng.run(make_requests(TrafficConfig(vocab=cfg.vocab, **WARMUP_TRACE)))
        picks = {"decode": ("paged_attention", None, TP_PICK_DECODE),
                 "prefill": ("paged_prefill_attention", scfg.prefill_chunk,
                             0)} if backend == TP_BACKENDS[-1] else None
        out, streams[backend], launches, n_copy, got, _ = tp_serve_run(
            pa, sc, eng, cfg, f"tp{TP_FULL} {backend}", picks)
        out["psum_model_ms_per_step"] = psum_model_ms_per_step(
            eng.ctx.tp_comm, sum(out["steps"].values()), dev)
        if not out["peak_gb"] < TP_PEAK * colo_peak:
            fail(f"tp {backend}: peak {out['peak_gb']:.2f} GB is not below "
                 f"{TP_PEAK} x the tp = 1 run's {colo_peak:.2f} GB")
        runs[backend] = out
        add(launches)
        copies += n_copy
        print(f"tp{TP_FULL} {backend}: " + json.dumps(out), flush=True)
    if streams["pallas"] != streams["posh"]:
        fail(f"tp: pallas streams differ from posh at "
             f"{divergences(streams['pallas'], streams['posh'])}")
    if sorted(got) != ["decode", "prefill"]:
        fail(f"tp: captured {sorted(got)} of the pallas run's paged calls")
    errs = tp_paged_parity(pa, got, eng.pool, 1, TP_FULL, f"tp{TP_FULL}")
    got = None
    # ``eng`` (pallas) computes what posh does, bit for bit; the gaps
    # between computations, read on fixed cases of the posh streams
    cases = gap_cases(reqs, streams["posh"])
    mine = decode_logits(eng, cfg, cases)
    xla = ServeEngine(params, cfg, scfg, device=dev,
                      ctx=ParallelCtx(tp_size=TP_FULL, backend="xla"))
    gaps = {"xla vs posh": gap_share(decode_logits(xla, cfg, cases), mine)}
    n_xla = near_tie_gate(
        eng, cfg, reqs, streams["xla"], streams["posh"], ("xla", "posh"),
        f"tp{TP_FULL}", got_logits=lambda c: decode_logits(xla, cfg, c))
    del xla
    tp1 = ServeEngine(unshard(params, cfg, TP_FULL), cfg, scfg, device=dev)
    tp1_logits = decode_logits(tp1, cfg, cases)
    gaps[f"tp{TP_FULL} vs tp1"] = gap_share(mine, tp1_logits)
    n_tp1 = near_tie_gate(
        tp1, cfg, reqs, streams["posh"], colo, (f"tp{TP_FULL}", "tp1"),
        f"tp{TP_FULL}", got_logits=lambda c: decode_logits(eng, cfg, c))
    del tp1
    faults = {name: gap_share(decode_logits(faulty(eng, k, cfg.n_layers),
                                            cfg, cases), mine)
              for name, k in tp_faults(cfg).items()}
    print(f"tp{TP_FULL}: pallas == posh bit for bit; xla leaves posh in "
          f"{n_xla} of {len(reqs)} streams, TP {TP_FULL} leaves tp = 1 in "
          f"{n_tp1}, each within the near-tie rule; peaks "
          f"{ {b: r['peak_gb'] for b, r in runs.items()} } GB vs tp = 1 "
          f"{colo_peak:.2f} GB", flush=True)

    # speculation under posh on the same stacked weights
    posh = ParallelCtx(tp_size=TP_FULL, backend="posh")
    eng = None
    gc.collect()
    torch.cuda.empty_cache()
    e2 = ServeEngine(params, cfg, spec_scfg(types.SimpleNamespace(scfg=scfg)),
                     device=dev, ctx=posh)
    pa.reset_launches()
    t1 = time.monotonic()
    with captured_calls(cfg.n_layers, {"verify": (
            "paged_prefill_attention", SPEC_K + 1, TP_PICK_VERIFY)}) as got:
        done = e2.run(reqs, clock="tick")
    torch.cuda.synchronize()
    wall = time.monotonic() - t1
    launches = dict(pa.LAUNCHES_BY_DTYPE)
    m = e2.metrics()
    if len(done) != len(reqs) or m["steps"]["decode"]:
        fail(f"tp spec: {len(done)} requests, steps {m['steps']}")
    spec_launches_ok(launches, cfg, m, {"prefill": 0, "decode": 0}, "bf16")
    add(launches)
    if sorted(got) != ["verify"]:
        fail(f"tp spec: no verify window captured of {m['steps']}")
    for k, v in tp_paged_parity(pa, got, e2.pool, 1, TP_FULL,
                                f"tp{TP_FULL} spec").items():
        errs[k] = max(errs.get(k, 0.0), v)
    got = None
    n_spec = near_tie_gate(
        e2, cfg, reqs, streams_of(done), streams["posh"],
        ("spec", "non-spec"), f"tp{TP_FULL} spec",
        got_logits=lambda c: decode_logits(e2, cfg, c, window_decode=True))
    print(f"tp{TP_FULL} spec k={SPEC_K} (ngram, posh): " + json.dumps(
        {"ticks": m["ticks"], "steps": m["steps"], "wall_s": wall,
         "tok_s": m["tokens_out"] / wall,
         "accept_rate": m["spec"]["accept_rate"],
         "tokens_per_tick": m["spec"]["tokens_per_tick"],
         "diverging_streams": n_spec}), flush=True)
    del e2, params
    gc.collect()
    torch.cuda.empty_cache()

    # 2+2 cells of TP 2 under posh on one stacked weights dict
    eng, cfg = build_engine(
        "qwen3-8b", config="full", dtype="bf16", device=dev, page_tokens=P,
        n_pages=512, max_batch=B, prefill_chunk=64, attn_impl="kernel",
        seed=0, ctx=ParallelCtx(tp_size=TP_CELLS, backend="posh"))
    out, colo2, launches, _, _, _ = tp_serve_run(pa, sc, eng, cfg,
                                                 f"tp{TP_CELLS} posh")
    add(launches)
    print(f"tp{TP_CELLS} posh (colocated): " + json.dumps(out), flush=True)
    gaps[f"tp{TP_CELLS} vs tp1"] = gap_share(decode_logits(eng, cfg, cases),
                                             tp1_logits)
    tp1 = ServeEngine(unshard(eng.exec.params, cfg, TP_CELLS), cfg, scfg,
                      device=dev)
    n_tp2 = near_tie_gate(
        tp1, cfg, reqs, colo2, colo, (f"tp{TP_CELLS}", "tp1"),
        f"tp{TP_CELLS}", got_logits=lambda c: decode_logits(eng, cfg, c))
    del tp1
    sound, planted = max(gaps.values()), min(faults.values())
    print("tp logit gaps on the fixed cases (output "
          f"{TP_GAP_J} of each request), as shares of |top logit|: sound "
          + json.dumps(gaps) + "; planted faults " + json.dumps(faults)
          + f"; NEAR_TIE_DELTA {NEAR_TIE_DELTA}", flush=True)
    if not sound < NEAR_TIE_DELTA < planted:
        fail(f"tp: the near-tie cap {NEAR_TIE_DELTA} does not separate the "
             f"sound computations' gap {sound:.4g} from a dropped psum's "
             f"{planted:.4g}")
    dout, dstreams, launches = disagg_run(pa, eng, cfg, TICK_TRACE, (2, 2),
                                          "host", 0, "bf16")
    add(launches)
    if not dout["peak_gb"] < 2 * weights_gb:
        fail(f"tp disagg: peak {dout['peak_gb']:.2f} GB is not below twice "
             f"the {weights_gb:.2f} GB of weights")
    n_dis = near_tie_gate(eng, cfg, reqs, dstreams, colo2,
                          ("disagg", "colocated"), f"tp{TP_CELLS} 2+2")
    print(f"tp{TP_CELLS}: leaves tp = 1 in {n_tp2} of {len(reqs)} streams "
          f"within the near-tie rule; 2+2 host cells (posh): "
          f"{len(reqs) - n_dis} of {len(reqs)} streams == colocated TP "
          f"{TP_CELLS}", flush=True)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    add(tp_smoke_streams(pa, dev))
    print(f"tp stage: {time.monotonic() - t0:.1f} s", flush=True)
    return total, copies, errs


# ----------------------------------------------------------------------
# phase 11: MoE serving at tp > 1
# ----------------------------------------------------------------------
def moe_streams_verdict(cfg, reqs, got: dict, want: dict, rec_got: list,
                        rec_want: list, labels, tag: str,
                        gated: bool) -> int:
    """``got``'s streams against ``want``'s, both runs recorded
    (``MoeRecorder``) on the same trace: the scheduler does not see the
    tokens (every request runs to ``max_new``), so both runs make the
    same steps over the same rows, event for event.  The root flip is
    the first row (in step, layer, row order) whose top-k set or kept
    set differs; each stream's first divergence is printed with
    ``want``'s top-2 logits at the token (its draw event) and whether
    the root flip came before it.  A divergence the root flip precedes
    passes when that flip changed the top-k set at a near-tie (the
    relative gate gap below F32_NEAR_TIE); one no flip precedes when
    ``want``'s top-2 margin there is below F32_NEAR_TIE x |top logit|.
    With ``gated`` False (bf16) this is printed, not checked.  Returns
    the number of diverging streams."""
    n_exp = cfg.moe.experts_padded(1)
    a_lab, b_lab = labels
    kinds = [(e["kind"], tuple(e["idx"].shape) if e["kind"] == "route"
              else len(e["rid"])) for e in rec_got]
    if kinds != [(e["kind"], tuple(e["idx"].shape) if e["kind"] == "route"
                  else len(e["rid"])) for e in rec_want]:
        fail(f"moe tp {tag}: the two runs' steps differ ({len(rec_got)} vs "
             f"{len(rec_want)} recorded calls)")
    root, n_flips, step, layer = None, 0, 0, 0
    for i, (x, y) in enumerate(zip(rec_got, rec_want)):
        if x["kind"] == "sample":
            step, layer = step + 1, 0
            continue
        (mx, kx), (my, ky) = route_sets(x, n_exp), route_sets(y, n_exp)
        rows = torch.nonzero((mx != my).any(1) | (kx != ky).any(1)).flatten()
        if len(rows):
            n_flips += 1
            if root is None:
                r = int(rows[0])
                root = {"event": i, "step": step, "layer": layer, "row": r,
                        "set": bool((mx[r] != my[r]).any()),
                        "gap": float(y["gap"][r]),
                        f"gap_{a_lab}": float(x["gap"][r])}
        layer += 1
    div = divergences(got, want)
    n_prompt = {r.rid: len(r.prompt) for r in reqs}
    bad = []
    for rid, j in div:
        pos = n_prompt[rid] + j
        hit = [(i, int(k)) for i, e in enumerate(rec_want)
               if e["kind"] == "sample"
               for k in torch.nonzero((e["rid"] == rid)
                                      & (e["pos"] == pos)).flatten()]
        if not hit:
            fail(f"moe tp {tag}: no draw of request {rid} output {j}")
        e, row = hit[-1]
        top = rec_want[e]["top"][row]
        mg, top_v = float(top[0] - top[1]), float(top[0])
        reached = root is not None and root["event"] < e
        ok = (root["set"] and root["gap"] < F32_NEAR_TIE) if reached \
            else mg < F32_NEAR_TIE * abs(top_v)
        print(f"moe tp {tag}: request {rid} output {j}: {a_lab} "
              f"{got[rid][j:j + 3]} vs {b_lab} {want[rid][j:j + 3]}; "
              f"{b_lab}'s top-2 margin {mg:.6g} at top {top_v:.6g} "
              f"({mg / max(abs(top_v), 1e-30):.3e} of it); "
              + ("after the root flip" if reached else "no flip before it"),
              flush=True)
        if not ok:
            bad.append((rid, j, mg, reached))
    print(f"moe tp {tag}: {len(div)} of {len(want)} streams leave {b_lab}; "
          f"{n_flips} routing calls differ; root flip "
          + (json.dumps(root) if root else "none")
          + f"; near-tie bar {F32_NEAR_TIE}"
          + ("" if gated else " (printed, not gated)"), flush=True)
    if gated and bad:
        fail(f"moe tp {tag}: {a_lab} leaves {b_lab} beyond a near-tie "
             f"(rid, output, margin, after the root flip): {bad}")
    return len(div)


def tp_layout_timing(pa, got: dict, tag: str) -> dict:
    """Each captured paged call of a TP step (``captured_calls``: the
    per-PE layout, every PE's rows in one launch) timed as phase 7 times
    the kernels: the kernel, its plain version, SDPA on the K/V gathered
    per row (the lengths' or the window's mask) and the bound (each live
    K/V token read once per KV head, q read and out written once).
    Returns {kernel name: the row}."""
    import torch.nn.functional as F

    out = {}
    for kind, args in sorted(got.items()):
        decode = kind == "decode"
        name = "paged_decode_attention" if decode else \
            "paged_prefill_attention"
        q, kp, vp, bt = args[:4]
        dt, isz = q.dtype, q.element_size()
        hkv, h = kp.shape[-2], q.shape[-2]
        rows = bt.shape[0]
        if decode:
            lim = args[4].long()[:, None]
            qs = q[:, :, None]
        else:
            start, n_tok = args[4].long(), args[5].long()
            j = torch.arange(q.shape[1], device=q.device)[None]
            lim = torch.where(j < n_tok[:, None], start[:, None] + j + 1,
                              torch.zeros_like(j))
            qs = q.transpose(1, 2)
        s = max(int(lim.max()), 1)
        bl = bt.long()
        kc = kp[bl].reshape(rows, -1, hkv, D)[:, :s].transpose(1, 2) \
            .contiguous()
        vc = vp[bl].reshape(rows, -1, hkv, D)[:, :s].transpose(1, 2) \
            .contiguous()
        # (rows, 1, 1 | C, s): key j visible to a query row below its limit
        mask = (torch.arange(s, device=q.device)[None, None]
                < lim[..., None])[:, None]
        seen = int(lim.max(-1).values.sum())
        flops = 4 * h * D * int(lim.sum())
        nbytes = (2 * q.numel() * isz + seen * hkv * D * isz * 2
                  + bt.numel() * 4 + 2 * rows * 4)
        ms = time_ms(lambda: getattr(pa, name)(*args), q.device)
        plain_ms = time_ms(lambda: getattr(pa, name + "_ref")(*args),
                           q.device)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qs, kc, vc, attn_mask=mask, enable_gqa=True), q.device)
        bound_ms, by = bound_of(nbytes, flops, dt)
        got_r = rates(ms, nbytes, flops, bound_ms)
        out[name] = {"q": list(q.shape), "kv_heads": hkv, "rows": rows,
                     "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                     "bound_ms": bound_ms, "bound_by": by,
                     "bound_bytes": nbytes, **got_r}
        print(f"timing {name} at the {tag} per-PE layout (q "
              f"{tuple(q.shape)} {str(dt)[6:]}, {hkv} KV heads a row, "
              f"{rows} rows = PEs x sequences): kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({by}); {rate_text(got_r)}", flush=True)
        del kc, vc
    return out


def moe_tp_stage(pa, sc, dev, moe1: dict, moe1_f32: dict) -> tuple:
    """Phase 11.  qwen3-moe-30b-a3b in bf16 at TP 4, one replica, posh,
    einsum: phase 4's ``MOE_TRACE`` served twice (the same streams;
    launches, collectives, peak under TP_PEAK x phase 4's tp = 1 peak
    and under 80 GB: ``tp_serve_run``), the paged kernels against their
    plain versions on the run's own decode and prefill inputs and timed
    there (the per-PE layout), the divergences from phase 4's tp = 1
    streams (``moe1``, carried as data) and the first step's routing
    flips printed; then pallas on the same trace, == posh bit for bit,
    the copy launches the staged rounds.  Then qwen2-moe-a2.7b in f32 at
    TP 4 (posh) under einsum and alltoall on the same trace,
    each held to the tp = 1 run (``moe1_f32``) by the f32 rules: the
    first step's held rows within LOGIT_TOL, every stream equal but at
    a near-tie (``moe_streams_verdict``); alltoall held to einsum the
    same way.  Then the smoke configs (``moe_tp_smoke``).  Returns the
    phase's paged launches by (kernel, dtype), its copy-kernel launches,
    the largest error of each paged kernel on the TP steps' inputs and
    the per-PE layout timings."""
    from repro_torch.parallel import ParallelCtx
    from repro_torch.serve import ServeEngine, TrafficConfig, make_requests

    t0 = time.monotonic()
    total: dict = {}
    errs: dict = {}
    layouts: dict = {}
    copies = 0

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    def worst(e):
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)

    # ---- qwen3-moe-30b-a3b, bf16, TP 4
    posh = ParallelCtx(tp_size=TP_FULL, backend="posh")
    eng, cfg = moe_engine(MOE_BF16, "bf16", dev, 512, posh)
    params, scfg = eng.exec.params, eng.scfg
    reqs = make_requests(TrafficConfig(vocab=cfg.vocab, **MOE_TRACE))
    eng.run(make_requests(TrafficConfig(vocab=cfg.vocab, **WARMUP_TRACE)),
            clock="tick")
    picks = {"decode": ("paged_attention", None, MOE_PICK_DECODE),
             "prefill": ("paged_prefill_attention", scfg.prefill_chunk, 0)}
    out, first, launches, _, got, _ = tp_serve_run(
        pa, sc, eng, cfg, f"{cfg.name} bf16 posh", picks, MOE_TRACE)
    print(f"moe tp {cfg.name} bf16 posh: " + json.dumps(out), flush=True)
    add(launches)
    gate = min(TP_PEAK * moe1["peak_gb"], 80.0)
    if not out["peak_gb"] < gate:
        fail(f"moe tp bf16: peak {out['peak_gb']:.2f} GB is not below "
             f"{gate:.2f} GB ({TP_PEAK} x the tp = 1 run's "
             f"{moe1['peak_gb']:.2f} GB, and 80)")
    if sorted(got) != ["decode", "prefill"]:
        fail(f"moe tp bf16: captured {sorted(got)} of the run's paged calls")
    worst(tp_paged_parity(pa, got, eng.pool, 1, TP_FULL, f"moe{TP_FULL}"))
    layouts[MOE_BF16] = tp_layout_timing(pa, got, f"{MOE_BF16} TP {TP_FULL}")
    got = None
    again_out, again, launches, _, _, rec = tp_serve_run(
        pa, sc, eng, cfg, f"{cfg.name} bf16 posh again", trace=MOE_TRACE,
        record=True)
    print(f"moe tp {cfg.name} bf16 posh again: " + json.dumps(again_out),
          flush=True)
    add(launches)
    if again != first:
        fail(f"moe tp bf16: the second run's streams differ at "
             f"{divergences(again, first)}")
    n_div = moe_streams_verdict(cfg, reqs, first, moe1["streams"], rec,
                                moe1["rec"], (f"tp{TP_FULL}", "tp1"),
                                f"{cfg.name} bf16", gated=False)
    rec = None
    moe_logits_verdict(cfg, moe_first_step(eng, cfg, reqs, "kernel",
                                           tok=moe1["first"]["tok"]),
                       moe1["first"], gated=False,
                       labels=(f"tp{TP_FULL}", "tp1"))
    print(f"moe tp bf16: the second run gave the same streams; {n_div} of "
          f"{len(reqs)} streams leave tp = 1 (printed, not gated); tok/s "
          f"{out['tok_s']:.2f} vs tp = 1 {moe1['run']['tok_s']:.2f}, peak "
          f"{out['peak_gb']:.2f} vs {moe1['peak_gb']:.2f} GB", flush=True)
    eng = None
    gc.collect()
    eng = ServeEngine(params, cfg, scfg, device=dev, ctx=ParallelCtx(
        tp_size=TP_FULL, backend="pallas"))
    pout, streams, launches, copies, _, _ = tp_serve_run(
        pa, sc, eng, cfg, f"{cfg.name} bf16 pallas", trace=MOE_TRACE)
    print(f"moe tp {cfg.name} bf16 pallas: " + json.dumps(pout), flush=True)
    add(launches)
    if streams != first:
        fail(f"moe tp bf16: pallas streams differ from posh at "
             f"{divergences(streams, first)}")
    print("moe tp bf16: pallas == posh bit for bit", flush=True)
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()

    # ---- qwen2-moe-a2.7b, f32, TP 4, einsum then alltoall
    eng, cfg = moe_engine(MOE_F32, "f32", dev, MOE_F32_PAGES, posh)
    params, scfg = eng.exec.params, eng.scfg
    reqs = make_requests(TrafficConfig(vocab=cfg.vocab, **MOE_TRACE))
    moe_logits_verdict(cfg, moe_first_step(eng, cfg, reqs, "kernel",
                                           tok=moe1_f32["first"]["tok"]),
                       moe1_f32["first"], gated=True,
                       labels=(f"tp{TP_FULL}", "tp1"))
    runs, recs = {}, {}
    for dispatch in ("einsum", "alltoall"):
        if dispatch != "einsum":
            eng = None
            gc.collect()
            eng = ServeEngine(params, cfg, scfg, device=dev, ctx=ParallelCtx(
                tp_size=TP_FULL, backend="posh", moe_dispatch=dispatch))
        out, runs[dispatch], launches, _, got, recs[dispatch] = tp_serve_run(
            pa, sc, eng, cfg, f"{cfg.name} f32 {dispatch}",
            picks if dispatch == "einsum" else None, MOE_TRACE, record=True)
        print(f"moe tp {cfg.name} f32 {dispatch}: " + json.dumps(out),
              flush=True)
        add(launches)
        gate = min(TP_PEAK * moe1_f32["peak_gb"], 80.0)
        if not out["peak_gb"] < gate:
            fail(f"moe tp f32 {dispatch}: peak {out['peak_gb']:.2f} GB is "
                 f"not below {gate:.2f} GB")
        if got:
            if sorted(got) != ["decode", "prefill"]:
                fail(f"moe tp f32: captured {sorted(got)} of the paged calls")
            worst(tp_paged_parity(pa, got, eng.pool, 1, TP_FULL,
                                  f"moe{TP_FULL} f32"))
            layouts[MOE_F32] = tp_layout_timing(pa, got,
                                                f"{MOE_F32} TP {TP_FULL}")
            got = None
        moe_streams_verdict(cfg, reqs, runs[dispatch], moe1_f32["streams"],
                            recs[dispatch], moe1_f32["rec"],
                            (f"tp{TP_FULL} {dispatch}", "tp1"),
                            f"{cfg.name} f32 {dispatch}", gated=True)
    moe_streams_verdict(cfg, reqs, runs["alltoall"], runs["einsum"],
                        recs["alltoall"], recs["einsum"],
                        ("alltoall", "einsum"), f"{cfg.name} f32",
                        gated=True)
    del eng, params, recs
    gc.collect()
    torch.cuda.empty_cache()
    add(moe_tp_smoke(pa, dev))
    print(f"moe tp stage: {time.monotonic() - t0:.1f} s", flush=True)
    return total, copies, errs, layouts


def moe_tp_smoke(pa, dev) -> dict:
    """The smoke MoE configs in f32 at TP 2 and 4 with two replicas,
    every backend and dispatch: greedy streams through the kernels ==
    through the plain versions, and with speculation (k = 2) through the
    kernels == the same; 2+2 cells of TP 2 (posh, both dispatches)
    through the kernels == the plain colocated TP 2 streams; each kernel
    run launches n_layers x its steps, each plain run none.  Returns the
    kernel runs' launches."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.parallel import ParallelCtx
    from repro_torch.serve import DisaggEngine, Request, ServeConfig

    t0 = time.monotonic()
    total: dict = {}
    n_runs = 0

    def reqs():
        return [Request(rid=i, prompt=list(p), max_new=6)
                for i, p in enumerate(SMOKE_PROMPTS)]

    for arch in (MOE_BF16, MOE_F32):
        cfg = configs.get_smoke(arch)
        params = lm.init(torch.Generator(device=dev).manual_seed(0), cfg,
                         device=dev)
        for tp in TP_SMOKE:
            for backend in TP_BACKENDS:
                for dispatch in ("einsum", "alltoall"):
                    ctx = ParallelCtx(tp_size=tp, backend=backend,
                                      moe_dispatch=dispatch)
                    what = f"{arch} tp={tp} {backend} {dispatch}"
                    streams = {}
                    for mode, impl, kw in (("plain", "ref", {}),
                                           ("plain", "kernel", {}),
                                           ("spec", "kernel",
                                            dict(spec_k=2))):
                        eng = smoke_tp_engine(params, cfg, ctx, impl, dev,
                                              **kw)
                        pa.reset_launches()
                        done = eng.run(reqs(), clock="tick")
                        smoke_launches_ok(pa, cfg, eng.steps, impl,
                                          f"{what} {mode}", total)
                        if mode == "spec" and not eng.steps["verify"]:
                            fail(f"moe tp smoke {what}: spec verified "
                                 f"nothing")
                        streams[mode, impl] = streams_of(done)
                        n_runs += 1
                    for key in (("plain", "kernel"), ("spec", "kernel")):
                        if streams[key] != streams["plain", "ref"]:
                            fail(f"moe tp smoke {what}: {key} streams "
                                 f"{streams[key]} != plain "
                                 f"{streams['plain', 'ref']}")
                    if tp == TP_CELLS and backend == "posh":
                        pa.reset_launches()
                        d = DisaggEngine(params, cfg, ServeConfig(
                            page_tokens=4, n_pages=24, max_batch=3,
                            max_seq=32, prefill_chunk=3, attn_impl="kernel"),
                            ctx=ctx, device=dev, n_prefill=2, n_decode=2)
                        done = d.run(reqs(), clock="tick")
                        steps = {k: sum(e.steps[k] for e in d.engines)
                                 for k in ("prefill", "decode", "verify")}
                        smoke_launches_ok(pa, cfg, steps, "kernel",
                                          f"{what} 2+2", total)
                        n_runs += 1
                        if streams_of(done) != streams["plain", "ref"] or \
                                d.stats()["handoff_quiets"]:
                            fail(f"moe tp smoke {what} 2+2: streams "
                                 f"{streams_of(done)} != colocated "
                                 f"{streams['plain', 'ref']} or "
                                 f"{d.stats()['handoff_quiets']} quiets")
    print(f"moe tp smoke f32 ({MOE_BF16}, {MOE_F32} smoke, tp {TP_SMOKE}, "
          f"{TP_SMOKE_REPLICAS} replicas, {TP_BACKENDS}, einsum and "
          f"alltoall): kernel streams == plain streams without and with "
          f"spec (k=2), 2+2 TP {TP_CELLS} cells == colocated; launches "
          f"n_layers x steps; {n_runs} runs in {time.monotonic() - t0:.1f} s",
          flush=True)
    return total


# ----------------------------------------------------------------------
# phase 12: data-parallel training
# ----------------------------------------------------------------------
class DpProbe:
    """Watches a DP train step from outside: ``combine_grads`` (the
    reduction, issue to unpack) and ``CommQueue.quiet`` (the drain)
    timed with CUDA events, the peak memory when the reduction starts
    (the backward's end), and whether every reduced row is row 0's
    bits."""

    def __init__(self):
        self.reduce_ms, self.drain_ms = [], []
        self.rows_equal, self.peak_at_reduce = [], []

    @contextlib.contextmanager
    def installed(self):
        from repro_torch.core import ordering
        from repro_torch.train import step as tstep
        from repro_torch.tree import leaves

        combine, quiet = tstep.combine_grads, ordering.CommQueue.quiet

        def timed(fn, out):
            def run(*a, **k):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                res = fn(*a, **k)
                e1.record()
                out.append((e0, e1))
                return res
            return run

        def reduce(grads, *a, **k):
            self.peak_at_reduce.append(torch.cuda.max_memory_allocated())
            res = timed_combine(grads, *a, **k)
            self.rows_equal.append(all(
                torch.equal(g, g[:1].expand_as(g)) for g in leaves(res[0])))
            return res

        timed_combine = timed(combine, self.reduce_ms)
        tstep.combine_grads = reduce
        ordering.CommQueue.quiet = timed(quiet, self.drain_ms)
        try:
            yield self
        finally:
            tstep.combine_grads = combine
            ordering.CommQueue.quiet = quiet

    @staticmethod
    def ms(events) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in events)


def dp_full(fa, sc, dev, base: dict) -> tuple:
    """Phase 12 (a): one full-depth DP 2 step (pallas, 4 MiB buckets,
    overlapped) on phase 6's global batch and seed.  Gates: the loss
    and grad norm within 1e-5 / 1e-4 of phase 6's step 0, the flash
    launches 2 x layers x microbatches x dp, the copy launches the
    staged rounds of ``dp_comm``'s calls, every reduced row row 0's bits,
    the peak under 80 GB.  Returns (flash, copy) launches."""
    from repro_torch.launch.train import build_trainer

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    tr = build_trainer(DP["arch"], global_batch=DP["global_batch"],
                       microbatches=DP["microbatches"], device=dev, seed=0,
                       dp_size=DP["dp"], backend=DP["backend"],
                       bucket_bytes=DP["bucket_bytes"],
                       overlap_grad_sync=True)
    torch.cuda.synchronize()
    cfg, comm = tr.cfg, tr.ctx.dp_comm
    init_s = time.monotonic() - t0
    probe = DpProbe()
    fa.reset_launches()
    sc.reset_launches()
    comm.reset_stats()
    with probe.installed():
        m = tr.step(0)
    torch.cuda.synchronize()
    flash, copies = fa.LAUNCHES["flash_attention"], sc.LAUNCHES["copy_blocked"]
    staged = staged_copy_launches(comm)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    tokens = DP["global_batch"] * cfg.max_seq
    res = {"loss": m["loss"], "grad_norm": m["grad_norm"],
           "dp1_loss": base["loss"], "dp1_grad_norm": base["grad_norm"],
           "seconds": m["seconds"], "tokens_per_s": tokens / m["seconds"],
           "init_s": init_s, "reduce_ms": DpProbe.ms(probe.reduce_ms),
           "drain_ms": DpProbe.ms(probe.drain_ms),
           "psum_calls": comm.stats().get("psum", {}).get("calls", 0),
           "peak_backward_gb": probe.peak_at_reduce[0] / 1e9,
           "peak_gb": peak, "peak_predicted_gb": DP_PEAK_PRED,
           "flash_launches": flash, "copy_launches": copies,
           "copy_launches_staged": staged,
           "rows_equal_row0": probe.rows_equal}
    res["reduce_share"] = res["reduce_ms"] / (m["seconds"] * 1e3)
    res["drain_share"] = res["drain_ms"] / (m["seconds"] * 1e3)
    print("dp full: " + json.dumps(res), flush=True)
    print(f"dp full: {cfg.name} DP {DP['dp']} {DP['backend']} step "
          f"{m['seconds']:.2f} s ({res['tokens_per_s']:.0f} tok/s), "
          f"reduction {res['reduce_ms']:.1f} ms ({res['reduce_share']:.1%}"
          f"; drain {res['drain_ms']:.1f} ms), peak "
          f"{res['peak_backward_gb']:.2f} GB at the backward's end "
          f"(predicted {DP_PEAK_PRED['backward']}) and {peak:.2f} GB "
          f"overall (predicted {DP_PEAK_PRED['drain']} at the drain)",
          flush=True)
    want = 2 * cfg.n_layers * DP["microbatches"] * DP["dp"]
    if flash != want:
        fail(f"dp full: flash launches {flash} != {want}")
    if copies != staged or not copies:
        fail(f"dp full: copy launches {copies} != the staged rounds {staged}")
    if probe.rows_equal != [True]:
        fail(f"dp full: a reduced row is not row 0's bits "
             f"{probe.rows_equal}")
    if not (math.isclose(m["loss"], base["loss"], rel_tol=1e-5)
            and math.isclose(m["grad_norm"], base["grad_norm"],
                             rel_tol=1e-4)):
        fail(f"dp full: loss / grad norm {m['loss']} / {m['grad_norm']} "
             f"leave phase 6's dp = 1 step {base['loss']} / "
             f"{base['grad_norm']}")
    if peak >= 80.0:
        fail(f"dp full: peak memory {peak:.2f} GB")
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return flash, copies


def dp_cut(fa, sc, dev) -> tuple:
    """Phase 12 (b): gemma-2b at 2 of 18 layers, DP 2, a row a replica,
    2 steps a run (``DP_CUT_RUNS``).  Gates: overlapped == blocking
    (per-leaf and 4 MiB buckets) and pallas == posh bit for bit (losses,
    grad norms, parameters); xla within 1e-5 of posh on the loss; bf16
    compression within 1e-3 of uncompressed on the loss; ZeRO-1's chunks
    ``(dp, c)``, ``state_to_tree``'s ``(dp * c,)`` leaves and its repeat's
    losses the same; every run's flash launches 2 x layers x dp x steps,
    each pallas run's copy launches its staged rounds.  Returns (flash,
    copy) launches."""
    from repro_torch.launch.train import build_trainer
    from repro_torch.train import state_to_tree
    from repro_torch.tree import leaves

    t_stage = time.monotonic()
    runs, keep = {}, {}
    flash_all = copy_all = 0
    for name, backend, kw in DP_CUT_RUNS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        tr = build_trainer(DP["arch"], global_batch=DP["cut_batch"],
                           microbatches=1, device=dev, seed=0,
                           n_layers=DP["cut_layers"], dp_size=DP["dp"],
                           backend=backend, **kw)
        comm = tr.ctx.dp_comm
        fa.reset_launches()
        sc.reset_launches()
        comm.reset_stats()
        ms = [tr.step(s) for s in range(DP["cut_steps"])]
        torch.cuda.synchronize()
        flash, copies = (fa.LAUNCHES["flash_attention"],
                         sc.LAUNCHES["copy_blocked"])
        staged = staged_copy_launches(comm) if backend == "pallas" else 0
        want = 2 * DP["cut_layers"] * DP["dp"] * DP["cut_steps"]
        if flash != want or copies != staged:
            fail(f"dp {name}: flash {flash} (want {want}), copies {copies} "
                 f"(staged rounds {staged})")
        flash_all += flash
        copy_all += copies
        runs[name] = {"losses": [m["loss"] for m in ms],
                      "grad_norms": [m["grad_norm"] for m in ms],
                      "step_s": [m["seconds"] for m in ms],
                      "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                      "copy_launches": copies}
        if name in ("leaf", "bucket", "zero1"):
            keep[name] = [p.detach().clone()
                          for p in leaves(tr.state["params"])]
        if name in ("overlap_leaf", "overlap_bucket", "posh_leaf",
                    "zero1_repeat"):
            other = {"overlap_leaf": "leaf", "overlap_bucket": "bucket",
                     "posh_leaf": "leaf", "zero1_repeat": "zero1"}[name]
            same = (runs[name]["losses"] == runs[other]["losses"]
                    and runs[name]["grad_norms"] == runs[other]["grad_norms"]
                    and all(torch.equal(a, b.detach()) for a, b in zip(
                        keep[other], leaves(tr.state["params"]))))
            runs[name]["bits_equal_" + other] = same
            if not same:
                fail(f"dp {name} != {other} bit for bit: {runs[name]} vs "
                     f"{runs[other]}")
        if name == "zero1":
            opt = tr.state["opt"]
            tree = state_to_tree(tr.state, device="meta")["opt"]["m"]
            for m_, t_ in zip(leaves(opt["m"]), leaves(tree)):
                if m_.dim() != 2 or m_.shape[0] != DP["dp"] or \
                        tuple(t_.shape) != (m_.numel(),):
                    fail(f"dp zero1: chunk {tuple(m_.shape)} -> tree leaf "
                         f"{tuple(t_.shape)}")
            runs[name]["chunks"] = [tuple(m_.shape)
                                    for m_ in leaves(opt["m"])][:4]
            del opt, tree
        del tr, ms
    posh, xla = runs["posh_leaf"]["losses"], runs["xla_leaf"]["losses"]
    bf16, plain = runs["bf16"]["losses"], runs["leaf"]["losses"]
    gaps = {"xla_vs_posh": max(abs(a - b) / abs(b)
                               for a, b in zip(xla, posh)),
            "bf16_vs_f32": max(abs(a - b) / abs(b)
                               for a, b in zip(bf16, plain))}
    print("dp cut: " + json.dumps({"runs": runs, "gaps": gaps}), flush=True)
    if not gaps["xla_vs_posh"] <= 1e-5:
        fail(f"dp cut: xla leaves posh by {gaps['xla_vs_posh']}")
    if not gaps["bf16_vs_f32"] <= 1e-3:
        fail(f"dp cut: bf16 compression moves the loss by "
             f"{gaps['bf16_vs_f32']}")
    if not all(math.isfinite(x) for r in runs.values() for x in r["losses"]):
        fail(f"dp cut: non-finite losses {runs}")
    print(f"dp cut: {len(runs)} runs, overlapped == blocking, pallas == "
          f"posh bit for bit; xla vs posh {gaps['xla_vs_posh']:.2e}, bf16 "
          f"vs f32 {gaps['bf16_vs_f32']:.2e}; zero1 peak "
          f"{runs['zero1']['peak_gb']:.2f} GB; stage "
          f"{time.monotonic() - t_stage:.1f} s", flush=True)
    return flash_all, copy_all


def dp_stage(fa, sc, dev, base: dict) -> tuple:
    """Phase 12: (a) then (b); returns the flash and copy launches."""
    fa_full, sc_full = dp_full(fa, sc, dev, base)
    fa_cut, sc_cut = dp_cut(fa, sc, dev)
    return fa_full + fa_cut, sc_full + sc_cut


# ----------------------------------------------------------------------
# phase 13: the RWKV and Mamba-hybrid families, minitron-4b and
# h2o-danube-3-4b, the contiguous-cache decode (ROADMAP A10, first part)
# ----------------------------------------------------------------------
def _peak_gb(dev) -> float:
    return torch.cuda.max_memory_allocated(dev) / 1e9


def _free(dev) -> None:
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)


def a10_flash_inputs(shape, dtype, dev, seed=13):
    """q, k, v as ``models.attention`` hands them to the kernel: (B, H, T,
    D) / (B, H_kv, S, D) views of (B, T, H, D) / (B, S, H_kv, D)
    tensors (row strides H * D and H_kv * D elements)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    t, h, hkv, d = A10_SEQ, shape["h"], shape["hkv"], shape["d"]
    q = torch.randn((1, t, h, d), generator=g, device=dev).to(dtype)
    k = torch.randn((1, t, hkv, d), generator=g, device=dev).to(dtype)
    v = torch.randn((1, t, hkv, d), generator=g, device=dev).to(dtype)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def a10_visible_pairs(t: int, window) -> int:
    """(row, column) pairs a causal (windowed) attention over t tokens
    computes: what this run's masks need."""
    return sum(min(r + 1, window or t) for r in range(t))


def a10_flash_parity(fa, dev) -> dict:
    """(d) The flash kernel against its plain version at the new paths'
    shapes (t = 4608, the window 4096 where the config has one), f32 and
    bf16, output and lse, phase 3's tolerances; then the autograd path
    at danube's windowed D = 120 shape."""
    errs = {}
    for tag, shape in A10_FLASH.items():
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = a10_flash_inputs(shape, dtype, dev)
            opts = dict(causal=True, window=shape["window"])
            n = fa.LAUNCHES["flash_attention"]
            out, lse = fa.flash_attention(q, k, v, **opts)
            ref, ref_lse = fa.flash_attention_ref(q, k, v, **opts)
            torch.cuda.synchronize()
            if fa.LAUNCHES["flash_attention"] != n + 1:
                fail(f"a10 flash {tag}: the kernel did not launch")
            err = max((out.float() - ref.float()).abs().max().item(),
                      (lse - ref_lse).abs().max().item())
            name = f"{tag} {'f32' if dtype == torch.float32 else 'bf16'}"
            print(f"a10 parity flash {name} (H {shape['h']} / H_kv "
                  f"{shape['hkv']}, D {shape['d']}, T=S={A10_SEQ}, window "
                  f"{shape['window']}): max |kernel - plain| {err:.3e} "
                  f"(tol {TOL[dtype]})", flush=True)
            if not err <= TOL[dtype]:
                fail(f"a10 flash {name}: {err} > {TOL[dtype]}")
            errs[name] = err
            del q, k, v, out, lse, ref, ref_lse
            torch.cuda.empty_cache()
    errs["autograd danube"] = a10_flash_autograd(dev)
    return errs


def a10_flash_autograd(dev) -> float:
    """``blocked_attention`` with the kernel forward and the plain
    backward against the all-plain path (output, dq, dk, dv) at danube's
    layout, D = 120, a window of 96 over a ragged T = 700, f32."""
    from repro_torch.models.flash import blocked_attention

    g = torch.Generator(device=dev).manual_seed(14)
    sh = A10_FLASH["danube"]
    shapes = ((1, 700, sh["h"], sh["d"]), (1, 700, sh["hkv"], sh["d"]),
              (1, 700, sh["hkv"], sh["d"]))
    base = [torch.randn(s, generator=g, device=dev) for s in shapes]
    dout = torch.randn(shapes[0], generator=g, device=dev)
    res = {}
    for impl in ("kernel", "ref"):
        q, k, v = (x.clone().requires_grad_(True) for x in base)
        out = blocked_attention(q, k, v, window=96, block_q=128, block_kv=64,
                                impl=impl)
        out.backward(dout)
        res[impl] = [out.detach(), q.grad, k.grad, v.grad]
    err = max((a - b).abs().max().item()
              for a, b in zip(res["kernel"], res["ref"]))
    print(f"a10 parity flash autograd (D 120, window 96, f32): max err over "
          f"out/dq/dk/dv {err:.3e} (tol {TOL[torch.float32]})", flush=True)
    if not err <= TOL[torch.float32]:
        fail(f"a10 autograd: kernel path vs plain path max err {err}")
    return err


def a10_flash_timing(fa, dev) -> dict:
    """The kernel, its plain version and SDPA (a boolean window mask, GQA)
    at the new shapes in each path's dtype, with the bound by operations
    over the pairs the window leaves."""
    import torch.nn.functional as F

    rows = {}
    for tag, dtype in A10_TIMED:
        shape = A10_FLASH[tag]
        q, k, v = a10_flash_inputs(shape, dtype, dev)
        h, hkv, d, w = shape["h"], shape["hkv"], shape["d"], shape["window"]
        pairs = a10_visible_pairs(A10_SEQ, w)
        flops = 4 * h * d * pairs
        isz = q.element_size()
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * isz \
            + h * A10_SEQ * 4
        opts = dict(causal=True, window=w)
        idx = torch.arange(A10_SEQ, device=dev)
        mask = idx[None] <= idx[:, None]
        if w:
            mask &= idx[None] > idx[:, None] - w
        qc, kc, vc = (x.contiguous() for x in (q, k, v))
        ms = time_ms(lambda: fa.flash_attention(q, k, v, **opts), dev)
        plain_ms = time_ms(lambda: fa.flash_attention_ref(q, k, v, **opts),
                           dev, iters=5)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qc, kc, vc, attn_mask=mask, enable_gqa=True), dev, iters=5)
        bound_ms, by = bound_of(nbytes, flops, dtype)
        name = f"{tag}_{'f32' if dtype == torch.float32 else 'bf16'}"
        rows[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                      "bound_ms": bound_ms, "bound_by": by,
                      "shape": {"h": h, "hkv": hkv, "d": d, "t": A10_SEQ,
                                "window": w}, "pairs": pairs,
                      **rates(ms, nbytes, flops, bound_ms)}
        print(f"timing flash_attention a10 {name} (H {h} / H_kv {hkv}, D {d}, "
              f"T=S={A10_SEQ}, window {w}): kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({by}; {pairs} pairs); "
              f"{rate_text(rows[name])}", flush=True)
        del q, k, v, qc, kc, vc, mask
        torch.cuda.empty_cache()
    return rows


def a10_stream_check(tokens, dec_logits, fwd_logits, tag, rule,
                     phase="a10") -> int:
    """Decode's greedy tokens (feeding the same inputs as the forward)
    against the forward's argmax at each position.  ``rule`` "f32": a
    difference passes at a top-2 margin of the forward's logits below
    F32_NEAR_TIE x |top|; "bf16": at one bf16 ulp of the top, or where
    the token lies within DELTA of the top and DELTA, the largest gap
    between the two computations' logits there, is at most
    NEAR_TIE_DELTA x |top| (``near_tie_gate``'s rule).  Returns the
    positions that differ."""
    want = fwd_logits.float().argmax(-1)
    bad, n_diff = [], 0
    for j in range(tokens.shape[0]):
        if int(tokens[j]) == int(want[j]):
            continue
        n_diff += 1
        lw = fwd_logits[j].float()
        vals, _ = lw.topk(2)
        top, mg = vals[0].item(), (vals[0] - vals[1]).item()
        gap = top - lw[int(tokens[j])].item()
        delta = (lw - dec_logits[j].float()).abs().max().item()
        ok = mg < F32_NEAR_TIE * abs(top) if rule == "f32" else (
            mg <= bf16_ulp(top)
            or gap <= delta <= NEAR_TIE_DELTA * abs(top))
        print(f"{phase} {tag}: position {j}: decode {int(tokens[j])} vs "
              f"forward "
              f"{int(want[j])}, top-2 margin {mg:.6g} at top {top:.6g}, the "
              f"token {gap:.6g} below it, logits {delta:.6g} apart "
              f"({'near-tie' if ok else 'NOT a near-tie'})", flush=True)
        if not ok:
            bad.append(j)
    if bad:
        fail(f"{phase} {tag}: decode leaves the forward beyond a near-tie at "
             f"positions {bad}")
    return n_diff


def a10_decode(params, cfg, ctx, inputs, dev, max_len, greedy=0):
    """Feed ``inputs`` (b, n) through ``decode_logits``, then ``greedy``
    more tokens; returns (tokens (b, n + greedy), logits of the fed
    positions (b, n, V), seconds)."""
    from repro_torch.models import lm
    b, n = inputs.shape
    state = lm.init_decode_state(cfg, ctx, b, max_len, device=dev)
    toks, logits = [], []
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with torch.no_grad():
        tok = inputs[:, 0]
        for i in range(n + greedy):
            if i < n:
                tok = inputs[:, i]
            lg, state = lm.decode_logits(params, tok, state, ctx, cfg)
            tok = lg.float().argmax(-1)
            toks.append(tok)
            if i < n:
                logits.append(lg)
    torch.cuda.synchronize()
    return torch.stack(toks, 1), torch.stack(logits, 1), \
        time.monotonic() - t0


def a10_train(fa, arch, layers, rows, mb, seq, dev, predict) -> dict:
    """One ``build_trainer`` step at published width (``layers`` kept, 0:
    all), f32: loss within 1.0 of ln(vocab), finite grad norm, flash
    launches == ``predict``, the peak printed."""
    from repro_torch.launch.train import build_trainer
    from repro_torch.tree import leaves

    _free(dev)
    t0 = time.monotonic()
    tr = build_trainer(arch, global_batch=rows, microbatches=mb, device=dev,
                       seed=0, n_layers=layers, seq_len=seq)
    n_params = sum(p.numel() for p in leaves(tr.state["params"]))
    state_gb = torch.cuda.memory_allocated(dev) / 1e9
    fa.reset_launches()
    m = tr.step(0)
    launches = fa.LAUNCHES["flash_attention"]
    peak = _peak_gb(dev)
    cfg = tr.cfg
    print(f"a10 train {cfg.name}: {cfg.n_layers} layers at published width, "
          f"{n_params / 1e9:.3f} B params f32 ({state_gb:.2f} GB of "
          f"parameters and Adam moments, {n_params * 16 / 1e9:.2f} GB at 16 B "
          f"a parameter with the gradients), "
          f"{rows} x {seq} tokens in {mb} microbatches: loss {m['loss']:.4f} "
          f"(ln vocab {math.log(cfg.vocab):.3f}), grad_norm "
          f"{m['grad_norm']:.4f}, {m['seconds']:.2f} s, "
          f"{rows * seq / m['seconds']:.0f} tok/s, peak {peak:.2f} GB, init "
          f"{time.monotonic() - t0 - m['seconds']:.1f} s, flash launches "
          f"{launches} (predicted {predict})", flush=True)
    if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
        fail(f"a10 train {arch}: loss {m['loss']} grad_norm {m['grad_norm']}")
    if not abs(m["loss"] - math.log(cfg.vocab)) < 1.0:
        fail(f"a10 train {arch}: loss {m['loss']} not within 1.0 of "
             f"ln(vocab)")
    if launches != predict:
        fail(f"a10 train {arch}: flash launches {launches} != {predict}")
    if peak >= 80.0:
        fail(f"a10 train {arch}: peak {peak:.2f} GB")
    return {"tr": tr, "launches": launches, "loss": m["loss"],
            "seconds": m["seconds"], "peak_gb": peak}


def a10_rwkv(fa, dev) -> int:
    """(a) rwkv6-3b: the published config, f32, all 32 layers, one step;
    then decode in bf16 on the trained weights; then at 2 layers in f32
    decode == the forward's argmax along a prompt."""
    import dataclasses as dc

    from repro_torch.models import lm
    from repro_torch.parallel import ParallelCtx
    from repro_torch.tree import tree_map

    r = A10_RWKV
    run = a10_train(fa, r["arch"], 0, r["rows"], 1, r["seq"], dev, 0)
    tr = run.pop("tr")
    cfg = tr.cfg
    params = tr.state["params"]
    tr.state.pop("opt")
    del tr
    gen = torch.Generator(device=dev).manual_seed(21)
    prompt = torch.randint(0, cfg.vocab, (r["rows"], r["prompt"]),
                           generator=gen, device=dev)
    bf = torch.bfloat16
    pbf = tree_map(lambda t: t.detach().to(bf), params)
    ctx = ParallelCtx(remat=False, param_dtype=bf, compute_dtype=bf)
    n = r["dec_prompt"]
    toks, _, sec = a10_decode(pbf, cfg, ctx, prompt[:, :n], dev,
                              n + r["new"], greedy=r["new"])
    print(f"a10 decode {cfg.name} bf16: {r['rows']} rows, {n} "
          f"prompt tokens then {r['new']} greedy through decode_step, "
          f"{sec:.2f} s ({r['rows'] * (n + r['new']) / sec:.1f} "
          f"tok/s), peak {_peak_gb(dev):.2f} GB; row 0's new tokens "
          f"{toks[0, n:].tolist()}", flush=True)
    if not bool(((toks >= 0) & (toks < cfg.padded_vocab(1))).all()):
        fail("a10 rwkv decode: a token outside the vocab")
    del pbf
    # 2 layers, f32: the recurrence against the chunked forward
    cut = dc.replace(cfg, n_layers=r["check_layers"])
    p2 = {**params, "blocks": params["blocks"][:r["check_layers"]]}
    f32 = ParallelCtx(remat=False, param_dtype=torch.float32,
                      compute_dtype=torch.float32)
    toks, dlog, _ = a10_decode(p2, cut, f32, prompt, dev, r["prompt"])
    with torch.no_grad():
        flog = lm.lm_head_logits(p2["head"], lm.forward(p2, prompt, f32, cut))
    n = sum(a10_stream_check(toks[i], dlog[i], flog[i],
                             f"rwkv {r['check_layers']} layers f32 row {i}",
                             "f32") for i in range(r["rows"]))
    err = (dlog.float() - flog.float()).abs().max().item()
    print(f"a10 rwkv {r['check_layers']} layers f32: decode == forward argmax "
          f"at {r['rows'] * r['prompt'] - n} of {r['rows'] * r['prompt']} "
          f"positions; max |decode - forward| logit {err:.3e} (largest "
          f"{flog.float().abs().max().item():.3f})", flush=True)
    del params, p2
    _free(dev)
    return 0


def a10_zamba2(fa, dev) -> int:
    """(b) zamba2-7b: the published config in bf16, all 81 layers:
    ``prefill`` of a 4160-token prompt (past the window; 13 launches of
    the bf16 flash body), then 8 tokens through ``decode_step`` from the
    prefill's pick, position 0 held to the forward's argmax by the
    near-tie rule, the later ones printed (the reference's one shared
    cache); then one f32 training step at 12 layers (2 whole groups).
    Returns the flash launches."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.parallel import ParallelCtx
    from repro_torch.tree import leaves

    z = A10_ZAMBA
    _free(dev)
    cfg = configs.get(z["arch"])
    bf = torch.bfloat16
    ctx = ParallelCtx(remat=False, param_dtype=bf, compute_dtype=bf)
    t0 = time.monotonic()
    params = lm.init(torch.Generator(device=dev).manual_seed(0), cfg,
                     dtype=bf, device=dev)
    n_params = sum(p.numel() for p in leaves(params))
    torch.cuda.synchronize()
    ng, rem = divmod(cfg.n_layers, cfg.shared_attn_every)
    print(f"a10 {cfg.name}: {cfg.n_layers} Mamba2 layers ({ng} groups of "
          f"{cfg.shared_attn_every} + {rem}), the shared block "
          f"{cfg.n_heads} heads x {cfg.head_dim}, window {cfg.swa_window}; "
          f"{n_params / 1e9:.3f} B params bf16, init "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    apps = cfg.n_layers // cfg.shared_attn_every
    gen = torch.Generator(device=dev).manual_seed(22)
    prompt = torch.randint(0, cfg.vocab, (1, z["prompt"]), generator=gen,
                           device=dev)
    fa.reset_launches()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with torch.no_grad():
        h = lm.prefill(params, prompt, ctx, cfg)
        first = lm.lm_head_logits(params["head"], h).float().argmax(-1)
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    pre = fa.LAUNCHES["flash_attention"]
    print(f"a10 prefill {cfg.name} bf16: {z['prompt']} tokens in {sec:.2f} s "
          f"({z['prompt'] / sec:.0f} tok/s), flash launches {pre} "
          f"(predicted {apps}), peak {_peak_gb(dev):.2f} GB, next token "
          f"{int(first[0])}", flush=True)
    if pre != apps:
        fail(f"a10 prefill: flash launches {pre} != {apps}")
    if not bool(torch.isfinite(h.float()).all()):
        fail("a10 prefill: non-finite hidden state")
    toks, dlog, sec = a10_decode(params, cfg, ctx, first[:, None], dev,
                                 z["new"] + 1, greedy=z["new"] - 1)
    fed = torch.cat([first[:, None], toks[:, :-1]], 1)   # the decode inputs
    fa.reset_launches()
    with torch.no_grad():
        flog = lm.lm_head_logits(params["head"],
                                 lm.forward(params, fed, ctx, cfg))
    fwd = fa.LAUNCHES["flash_attention"]
    if fwd != apps:
        fail(f"a10 zamba2 forward: flash launches {fwd} != {apps}")
    a10_stream_check(toks[0, :1], dlog[0, :1], flog[0, :1],
                     "zamba2 bf16 position 0", "bf16")
    want = flog[0].float().argmax(-1)
    agree = [int(a) == int(b) for a, b in zip(toks[0], want)]
    print(f"a10 decode {cfg.name} bf16: {z['new']} tokens in {sec:.2f} s "
          f"({z['new'] / sec:.1f} tok/s), peak {_peak_gb(dev):.2f} GB; "
          f"decode == the forward's argmax at {sum(agree)} of {z['new']} "
          f"positions (printed, not gated past position 0: the reference "
          f"threads one shared cache through the {apps} applications); "
          f"first difference at "
          f"{agree.index(False) if False in agree else None}", flush=True)
    del params, h, dlog, flog
    _free(dev)
    run = a10_train(fa, z["arch"], z["train_layers"], z["rows"], z["mb"],
                    z["seq"], dev,
                    z["train_layers"] // cfg.shared_attn_every * z["mb"])
    train = run["launches"]
    del run
    _free(dev)
    return pre + fwd + train


def a10_dense(fa, dev) -> int:
    """(c) h2o-danube-3-4b (window 4096 at t = 4608) and minitron-4b
    (GQA group 3, relu2) at published width cut to 4 layers, f32, one
    step each; then danube's published config in bf16: 16 prompt tokens
    and 16 more through ``decode_step`` (its ring cache, S = 4096).
    Returns the flash launches."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.parallel import ParallelCtx

    total = 0
    for arch, layers, seq in A10_DENSE:
        run = a10_train(fa, arch, layers, A10_DENSE_ROWS, A10_DENSE_ROWS,
                        seq, dev, layers * A10_DENSE_ROWS * 2)
        total += run["launches"]
        del run
        _free(dev)
    cfg = configs.get("h2o-danube-3-4b")
    bf = torch.bfloat16
    ctx = ParallelCtx(remat=False, param_dtype=bf, compute_dtype=bf)
    params = lm.init(torch.Generator(device=dev).manual_seed(0), cfg,
                     dtype=bf, device=dev)
    gen = torch.Generator(device=dev).manual_seed(23)
    n, new = A10_DANUBE_DECODE["prompt"], A10_DANUBE_DECODE["new"]
    prompt = torch.randint(0, cfg.vocab, (2, n), generator=gen, device=dev)
    toks, _, sec = a10_decode(params, cfg, ctx, prompt, dev, n + new,
                              greedy=new)
    print(f"a10 decode {cfg.name} bf16: 2 rows, {n} prompt tokens then {new} "
          f"greedy, {sec:.2f} s ({2 * (n + new) / sec:.1f} tok/s), peak "
          f"{_peak_gb(dev):.2f} GB; row 0's new tokens "
          f"{toks[0, n:].tolist()}", flush=True)
    if not bool(((toks >= 0) & (toks < cfg.padded_vocab(1))).all()):
        fail("a10 danube decode: a token outside the vocab")
    del params
    _free(dev)
    return total


def a10_stage(fa, dev) -> tuple:
    """Phase 13: (d) the flash kernel at the new shapes, then (a), (b),
    (c) on the card; returns (flash launches on the new paths, the
    parity errors, the timing rows)."""
    from repro_torch import configs

    errs = a10_flash_parity(fa, dev)
    rows = a10_flash_timing(fa, dev)
    launches = a10_rwkv(fa, dev) + a10_zamba2(fa, dev) + a10_dense(fa, dev)
    zamba = configs.get("zamba2-7b")
    apps = zamba.n_layers // zamba.shared_attn_every
    predict = 2 * apps + A10_ZAMBA["train_layers"] // \
        zamba.shared_attn_every * A10_ZAMBA["mb"] + sum(
            layers * A10_DENSE_ROWS * 2 for _, layers, _ in A10_DENSE)
    print(f"a10: flash launches on the new paths {launches} (predicted "
          f"{predict}: prefill and the forward {apps} each, zamba2 training "
          f"{A10_ZAMBA['train_layers'] // zamba.shared_attn_every} "
          f"applications x {A10_ZAMBA['mb']} microbatches, no remat of the "
          f"shared block; danube and minitron "
          f"{' and '.join(str(n) for _, n, _ in A10_DENSE)} layers x "
          f"{A10_DENSE_ROWS} microbatches x 2 under remat)", flush=True)
    if launches != predict:
        fail(f"a10: flash launches {launches} != predicted {predict}")
    return launches, errs, rows


# ----------------------------------------------------------------------
# phase 14: the cross-attention families, whisper-base (encoder-decoder)
# and llama-3.2-vision-90b (ROADMAP A10, items 1-2)
# ----------------------------------------------------------------------
def xattn_flash_inputs(shape, dtype, dev, seed=31):
    """q (B, H, T, D) and k, v (B, H_kv, S, D) as ``models.attention``
    hands them to the kernel: views of (B, T, H, D) / (B, S, H_kv, D)
    tensors (cross attention's K/V are ``cross_kv``'s projection at the
    encoder's / image's length S)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    b, h, hkv, t, s, d = (shape[k] for k in ("b", "h", "hkv", "t", "s", "d"))
    q = torch.randn((b, t, h, d), generator=g, device=dev).to(dtype)
    k = torch.randn((b, s, hkv, d), generator=g, device=dev).to(dtype)
    v = torch.randn((b, s, hkv, d), generator=g, device=dev).to(dtype)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def xattn_flash_parity(fa, dev) -> dict:
    """(d) The flash kernel against its plain version at the new shapes,
    non-causal, f32 and bf16, output and lse (phase 3's tolerances);
    then the autograd path at whisper's cross shape."""
    from repro_torch.models.flash import blocked_attention

    errs = {}
    for tag, shape in XATTN_FLASH.items():
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = xattn_flash_inputs(shape, dtype, dev)
            n = fa.LAUNCHES["flash_attention"]
            out, lse = fa.flash_attention(q, k, v, causal=False)
            ref, ref_lse = fa.flash_attention_ref(q, k, v, causal=False)
            torch.cuda.synchronize()
            if fa.LAUNCHES["flash_attention"] != n + 1:
                fail(f"xattn flash {tag}: the kernel did not launch")
            err = max((out.float() - ref.float()).abs().max().item(),
                      (lse - ref_lse).abs().max().item())
            name = f"{tag} {'f32' if dtype == torch.float32 else 'bf16'}"
            print(f"xattn parity flash {name} ({xattn_shape_text(shape)}): "
                  f"max |kernel - plain| {err:.3e} (tol {TOL[dtype]})",
                  flush=True)
            if not err <= TOL[dtype]:
                fail(f"xattn flash {name}: {err} > {TOL[dtype]}")
            errs[name] = err
            del q, k, v, out, lse, ref, ref_lse
    # the autograd path: kernel forward + plain backward vs all plain
    sh = XATTN_FLASH["whisper_cross"]
    g = torch.Generator(device=dev).manual_seed(32)
    base = [torch.randn((sh["b"], n, hh, sh["d"]), generator=g, device=dev)
            for n, hh in ((sh["t"], sh["h"]), (sh["s"], sh["hkv"]),
                          (sh["s"], sh["hkv"]))]
    dout = torch.randn(base[0].shape, generator=g, device=dev)
    res = {}
    for impl in ("kernel", "ref"):
        q, k, v = (x.clone().requires_grad_(True) for x in base)
        out = blocked_attention(q, k, v, causal=False, impl=impl)
        out.backward(dout)
        res[impl] = [out.detach(), q.grad, k.grad, v.grad]
    err = max((a - b).abs().max().item()
              for a, b in zip(res["kernel"], res["ref"]))
    print(f"xattn parity flash autograd (whisper cross, f32): max err over "
          f"out/dq/dk/dv {err:.3e} (tol {TOL[torch.float32]})", flush=True)
    if not err <= TOL[torch.float32]:
        fail(f"xattn autograd: kernel path vs plain path max err {err}")
    errs["autograd whisper_cross"] = err
    _free(dev)
    return errs


def xattn_shape_text(sh) -> str:
    return (f"B {sh['b']}, H {sh['h']} / H_kv {sh['hkv']}, T {sh['t']}, S "
            f"{sh['s']}, D {sh['d']}, non-causal")


def xattn_flash_timing(fa, dev) -> dict:
    """The kernel, its plain version and SDPA (non-causal, GQA) at the new
    shapes in each path's dtype, with the bound: every (row, column) pair
    computed, 4 T S D operations a head."""
    import torch.nn.functional as F

    rows = {}
    for tag, dtype in XATTN_TIMED:
        sh = XATTN_FLASH[tag]
        q, k, v = xattn_flash_inputs(sh, dtype, dev)
        b, h, t, s, d = sh["b"], sh["h"], sh["t"], sh["s"], sh["d"]
        flops = 4 * b * h * t * s * d
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() \
            + b * h * t * 4
        qc, kc, vc = (x.contiguous() for x in (q, k, v))
        ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=False), dev)
        plain_ms = time_ms(lambda: fa.flash_attention_ref(q, k, v,
                                                          causal=False),
                           dev, iters=5)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qc, kc, vc, enable_gqa=True), dev, iters=5)
        bound_ms, by = bound_of(nbytes, flops, dtype)
        name = f"{tag}_{'f32' if dtype == torch.float32 else 'bf16'}"
        rows[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                      "bound_ms": bound_ms, "bound_by": by, "shape": sh,
                      **rates(ms, nbytes, flops, bound_ms)}
        print(f"timing flash_attention xattn {name} ({xattn_shape_text(sh)})"
              f": kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
              f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}); "
              f"{rate_text(rows[name])}", flush=True)
        del q, k, v, qc, kc, vc
    _free(dev)
    return rows


def xattn_greedy(step, start, n) -> tuple:
    """``n`` greedy steps of ``step(token (b,)) -> logits (b, V)`` from
    ``start``: (tokens (b, n), logits (b, n, V), seconds)."""
    tok, toks, logits = start, [], []
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with torch.no_grad():
        for _ in range(n):
            lg = step(tok)
            tok = lg.float().argmax(-1)
            toks.append(tok)
            logits.append(lg)
    torch.cuda.synchronize()
    return torch.stack(toks, 1), torch.stack(logits, 1), \
        time.monotonic() - t0


def xattn_whisper_batch(cfg, dev, rows, seq, seed):
    """Seeded tokens (rows, seq + 1) and unit-normal frames (rows,
    enc_frames, d_model) on the card (the conv frontend is a stub there
    and here)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return {"tokens": torch.randint(0, cfg.vocab, (rows, seq + 1),
                                    generator=g, device=dev),
            "frames": torch.randn((rows, cfg.enc_frames, cfg.d_model),
                                  generator=g, device=dev)}


def xattn_whisper_train(fa, dev) -> tuple:
    """(a) whisper-base's published config, f32, all 6 + 6 layers: one
    ``make_train_step`` step of 8 rows (1500 frames, 448 + 1 tokens) in
    2 microbatches.  Gates: loss within 1.0 of ln(vocab), a finite grad
    norm, flash launches == (enc + 2 dec) layers x microbatches x 2
    (remat).  Returns (the trained parameters, the batch, launches)."""
    from repro_torch import configs
    from repro_torch.models import registry
    from repro_torch.parallel import ParallelCtx
    from repro_torch.train import AdamWConfig, init_train_state, \
        make_train_step
    from repro_torch.tree import leaves

    w = XATTN_WHISPER
    _free(dev)
    cfg = configs.get("whisper-base")
    ctx = ParallelCtx(remat=True, param_dtype=torch.float32,
                      compute_dtype=torch.float32)
    api = registry.build(cfg)
    opt = AdamWConfig()
    t0 = time.monotonic()
    state = init_train_state(torch.Generator(device=dev).manual_seed(0), cfg,
                             ctx, api, opt, device=dev)
    step = make_train_step(cfg, ctx, api, opt, microbatches=w["mb"])
    n_params = sum(p.numel() for p in leaves(state["params"]))
    batch = xattn_whisper_batch(cfg, dev, w["rows"], w["seq"], 0)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    fa.reset_launches()
    t0 = time.monotonic()
    state, m = step(state, batch)
    loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    launches = fa.LAUNCHES["flash_attention"]
    predict = (cfg.enc_layers + 2 * cfg.n_layers) * w["mb"] * 2
    peak = _peak_gb(dev)
    print(f"xattn train {cfg.name}: {cfg.enc_layers} + {cfg.n_layers} "
          f"layers at published width, {n_params / 1e6:.2f} M params f32 "
          f"(pos_dec {cfg.max_seq * 16 * cfg.d_model / 1e6:.2f} M), "
          f"{n_params * 16 / 1e9:.2f} GB at 16 B a parameter; {w['rows']} "
          f"rows x ({cfg.enc_frames} frames, {w['seq']} + 1 tokens) in "
          f"{w['mb']} microbatches: loss {loss:.4f} (ln vocab "
          f"{math.log(cfg.vocab):.3f}), grad_norm {gnorm:.4f}, {sec:.2f} s "
          f"({w['rows'] * w['seq'] / sec:.0f} decoder tok/s), peak "
          f"{peak:.2f} GB, init {init_s:.1f} s, flash launches {launches} "
          f"(predicted {predict})", flush=True)
    if not (math.isfinite(loss) and math.isfinite(gnorm)):
        fail(f"xattn whisper train: loss {loss} grad_norm {gnorm}")
    if not abs(loss - math.log(cfg.vocab)) < 1.0:
        fail(f"xattn whisper train: loss {loss} not within 1.0 of ln(vocab)")
    if launches != predict:
        fail(f"xattn whisper train: flash launches {launches} != {predict}")
    params = state["params"]
    state.pop("opt")
    return params, batch, launches, {"loss": loss, "grad_norm": gnorm,
                                     "step_s": sec, "peak_gb": peak}


def xattn_whisper_decode(fa, params, batch, dev) -> int:
    """(b) whisper decode on the trained weights, in f32 and in bf16
    compute: ``encode`` over 1500 frames of 4 rows, ``encoder_cross_kv``,
    then 64 greedy tokens through ``decode_step`` from a seeded start
    token; the teacher-forced ``decode_train`` over the same inputs must
    give the same argmax at every position, a difference allowed only as
    a near-tie by phase 13's bf16 rule (the self-attention caches are
    bf16 in both dtypes, as the reference's).  Returns the flash
    launches (encode and decode_train of each run)."""
    from repro_torch import configs
    from repro_torch.models import encdec
    from repro_torch.models.embed import lm_head_logits
    from repro_torch.parallel import ParallelCtx
    from repro_torch.tree import tree_map

    w = XATTN_WHISPER
    cfg = configs.get("whisper-base")
    rows, n = w["dec_rows"], w["new"]
    frames = batch["frames"][:rows]
    start = batch["tokens"][:rows, 0]
    total = 0
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        p = params if dtype == torch.float32 else tree_map(
            lambda t: t.detach().to(dtype), params)
        ctx = ParallelCtx(remat=False, param_dtype=dtype, compute_dtype=dtype)
        fa.reset_launches()
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.monotonic()
            enc = encdec.encode(p, frames, ctx, cfg)
            torch.cuda.synchronize()
            enc_ms = (time.monotonic() - t0) * 1e3
            ekv = encdec.encoder_cross_kv(p, enc, ctx, cfg)
            state = encdec.init_decode_state(cfg, ctx, rows, n, device=dev)
            toks, dlog, sec = xattn_greedy(
                lambda t: encdec.decode_logits(p, t, state, ekv, ctx,
                                               cfg)[0], start, n)
            fed = torch.cat([start[:, None], toks[:, :-1]], 1)
            x = encdec.decode_train(p, fed, enc, ctx, cfg)
            flog = lm_head_logits(p["embed"], x)
        launches = fa.LAUNCHES["flash_attention"]
        predict = cfg.enc_layers + 2 * cfg.n_layers
        diff = sum(a10_stream_check(toks[i], dlog[i], flog[i],
                                    f"whisper {tag} row {i}", "bf16",
                                    phase="xattn") for i in range(rows))
        err = (dlog.float() - flog.float()).abs().max().item()
        print(f"xattn decode {cfg.name} {tag}: {rows} rows, encoder over "
              f"{cfg.enc_frames} frames {enc_ms:.1f} ms, {n} greedy tokens "
              f"through decode_step {sec:.2f} s ({rows * n / sec:.1f} tok/s), "
              f"decode == decode_train's argmax at {rows * n - diff} of "
              f"{rows * n} positions, max |decode - forward| logit "
              f"{err:.3e} (largest {flog.float().abs().max().item():.3f}); "
              f"flash launches {launches} (predicted {predict}: the encoder "
              f"and decode_train's self and cross layers), peak "
              f"{_peak_gb(dev):.2f} GB; row 0's tokens "
              f"{toks[0, :16].tolist()}...", flush=True)
        if launches != predict:
            fail(f"xattn whisper decode {tag}: flash launches {launches} != "
                 f"{predict}")
        total += launches
        del p, enc, ekv, state, dlog, flog, x
    _free(dev)
    return total


def xattn_vlm(fa, dev) -> tuple:
    """(c) llama-3.2-vision-90b's published width in bf16 at 2 of its 20
    groups (``cut_layers``: 8 dense + 2 cross layers), both gates of each
    group set non-zero: ``prefill`` of 2 x 1024 tokens against 1601
    seeded image embeddings, then 32 tokens through ``decode_step`` from
    the prefill's pick with ``img_kv`` (each group's ``cross_kv``,
    stacked), held to ``forward``'s argmax over the same inputs by the
    bf16 near-tie rule.  Returns (flash launches, figures)."""
    from repro_torch import configs
    from repro_torch.launch.train import cut_layers
    from repro_torch.models import lm
    from repro_torch.models.attention import cross_kv
    from repro_torch.parallel import ParallelCtx
    from repro_torch.tree import leaves

    vv = XATTN_VLM
    _free(dev)
    full = configs.get("llama-3.2-vision-90b")
    cfg = cut_layers(full, vv["groups"] * full.cross_attn_every)
    ng = cfg.n_layers // cfg.cross_attn_every
    bf = torch.bfloat16
    ctx = ParallelCtx(remat=False, param_dtype=bf, compute_dtype=bf)
    t0 = time.monotonic()
    params = lm.init(torch.Generator(device=dev).manual_seed(0), cfg,
                     dtype=bf, device=dev)
    for name, vals in XATTN_GATES.items():
        params["cross"][name].copy_(torch.tensor(vals, dtype=bf)[:, None])
    n_params = sum(p.numel() for p in leaves(params))
    g = torch.Generator(device=dev).manual_seed(41)
    img = torch.randn((vv["rows"], cfg.img_tokens, cfg.d_model), generator=g,
                      device=dev).to(bf)
    prompt = torch.randint(0, cfg.vocab, (vv["rows"], vv["prompt"]),
                           generator=g, device=dev)
    torch.cuda.synchronize()
    print(f"xattn {cfg.name}: {ng} of {full.n_layers // full.cross_attn_every}"
          f" groups ({ng * (cfg.cross_attn_every - 1)} dense + {ng} cross "
          f"layers) at published width, {cfg.n_heads} / {cfg.n_kv} heads x "
          f"{cfg.head_dim}; {n_params / 1e9:.3f} B params bf16 "
          f"({n_params * 2 / 1e9:.2f} GB), gates {XATTN_GATES}, init "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    fa.reset_launches()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with torch.no_grad():
        h = lm.prefill(params, prompt, ctx, cfg, img_embeds=img)
        first = lm.lm_head_logits(params["head"], h).float().argmax(-1)
    torch.cuda.synchronize()
    pre_s = time.monotonic() - t0
    pre = fa.LAUNCHES["flash_attention"]
    print(f"xattn prefill {cfg.name} bf16: {vv['rows']} x {vv['prompt']} "
          f"tokens against {cfg.img_tokens} image rows in {pre_s:.2f} s "
          f"({vv['rows'] * vv['prompt'] / pre_s:.0f} tok/s), flash launches "
          f"{pre} (predicted {cfg.n_layers}), peak {_peak_gb(dev):.2f} GB",
          flush=True)
    if pre != cfg.n_layers:
        fail(f"xattn vlm prefill: flash launches {pre} != {cfg.n_layers}")
    if not bool(torch.isfinite(h.float()).all()):
        fail("xattn vlm prefill: non-finite hidden state")
    with torch.no_grad():
        kvs = [cross_kv(lm.layer(params["cross"], gi)["xattn"], img, ctx,
                        cfg) for gi in range(ng)]
        img_kv = (torch.stack([k for k, _ in kvs]),
                  torch.stack([v for _, v in kvs]))
        del kvs
        state = lm.init_decode_state(cfg, ctx, vv["rows"], vv["new"],
                                     device=dev)
        toks, dlog, dec_s = xattn_greedy(
            lambda t: lm.decode_logits(params, t, state, ctx, cfg,
                                       img_kv=img_kv)[0], first, vv["new"])
        fed = torch.cat([first[:, None], toks[:, :-1]], 1)
        fa.reset_launches()
        flog = lm.lm_head_logits(params["head"],
                                 lm.forward(params, fed, ctx, cfg,
                                            img_embeds=img))
    fwd = fa.LAUNCHES["flash_attention"]
    if fwd != cfg.n_layers:
        fail(f"xattn vlm forward: flash launches {fwd} != {cfg.n_layers}")
    diff = sum(a10_stream_check(toks[i], dlog[i], flog[i],
                                f"vlm bf16 row {i}", "bf16", phase="xattn")
               for i in range(vv["rows"]))
    peak = _peak_gb(dev)
    n = vv["rows"] * vv["new"]
    print(f"xattn decode {cfg.name} bf16: {vv['new']} tokens a row through "
          f"decode_step in {dec_s:.2f} s ({n / dec_s:.1f} tok/s), decode == "
          f"forward's argmax at {n - diff} of {n} positions, max |decode - "
          f"forward| logit {(dlog.float() - flog.float()).abs().max().item():.3e}"
          f"; peak {peak:.2f} GB; row 0's tokens {toks[0].tolist()}",
          flush=True)
    if peak >= 80.0:
        fail(f"xattn vlm: peak {peak:.2f} GB")
    del params, img, img_kv, state, h, dlog, flog
    _free(dev)
    return pre + fwd, {"prefill_s": pre_s, "decode_tok_s": n / dec_s,
                       "peak_gb": peak, "params_b": n_params / 1e9}


def xattn_vlm_smoke_grads(fa, dev) -> int:
    """The vlm trains only at the smoke config on the card (full width's
    AdamW state would not fit): loss and every gradient with the flash
    kernel against the plain forward, both gates non-zero.  Gates: loss
    within 1e-5 relative, each leaf's gradient within TOL[f32] of the
    plain path's (plus TOL[f32] of its largest), kernel launches ==
    groups x (dense layers x 2 under remat + 1 cross).  Returns the
    kernel path's launches."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.parallel import ParallelCtx
    from repro_torch.train.grad import trainable
    from repro_torch.tree import leaves

    cfg = configs.get_smoke("llama-3.2-vision-90b")
    params = lm.init(torch.Generator(device=dev).manual_seed(5), cfg,
                     device=dev)
    for name, vals in XATTN_GATES.items():
        params["cross"][name].copy_(torch.tensor(vals)[:, None])
    g = torch.Generator(device=dev).manual_seed(6)
    batch = {"tokens": torch.randint(0, cfg.vocab, (4, cfg.max_seq + 1),
                                     generator=g, device=dev),
             "img_embeds": torch.randn((4, cfg.img_tokens, cfg.d_model),
                                       generator=g, device=dev)}
    out = {}
    for impl in ("ref", "kernel"):
        ctx = ParallelCtx(remat=True, attn_impl=impl,
                          param_dtype=torch.float32,
                          compute_dtype=torch.float32)
        p = trainable(lm.unstack(params))
        fa.reset_launches()
        loss = lm.loss_fn(p, batch, ctx, cfg)
        loss.backward()
        out[impl] = (float(loss.detach()), [t.grad for t in leaves(p)],
                     fa.LAUNCHES["flash_attention"])
    ng = cfg.n_layers // cfg.cross_attn_every
    predict = ng * ((cfg.cross_attn_every - 1) * 2 + 1)
    worst = max(((a - b).abs().max() / (1 + b.abs().max())).item()
                for a, b in zip(out["kernel"][1], out["ref"][1]))
    print(f"xattn vlm smoke f32 grads: loss kernel {out['kernel'][0]:.6f} vs "
          f"plain {out['ref'][0]:.6f}, worst leaf |kernel - plain| / (1 + "
          f"max |plain|) {worst:.3e} (tol {TOL[torch.float32]}), launches "
          f"{out['kernel'][2]} (predicted {predict})", flush=True)
    if abs(out["kernel"][0] - out["ref"][0]) > 1e-5 * abs(out["ref"][0]):
        fail("xattn vlm smoke: kernel loss leaves the plain loss")
    if not worst <= TOL[torch.float32]:
        fail(f"xattn vlm smoke: gradient error {worst}")
    if out["kernel"][2] != predict or out["ref"][2] != 0:
        fail(f"xattn vlm smoke: launches {out['kernel'][2]} / "
             f"{out['ref'][2]}, predicted {predict} / 0")
    return out["kernel"][2]


def xattn_stage(fa, dev) -> tuple:
    """Phase 14: (d) the flash kernel at the new shapes, then (a)-(c) on
    the card; returns (flash launches on the new paths, the parity
    errors, the timing rows)."""
    errs = xattn_flash_parity(fa, dev)
    rows = xattn_flash_timing(fa, dev)
    params, batch, train, figs = xattn_whisper_train(fa, dev)
    decode = xattn_whisper_decode(fa, params, batch, dev)
    del params, batch
    _free(dev)
    vlm, vfigs = xattn_vlm(fa, dev)
    smoke = xattn_vlm_smoke_grads(fa, dev)
    launches = train + decode + vlm + smoke
    print(f"xattn: flash launches on the new paths {launches} (whisper step "
          f"{train}, whisper decode runs {decode}, vlm prefill + forward "
          f"{vlm}, vlm smoke grads {smoke}); whisper {figs}, vlm {vfigs}",
          flush=True)
    return launches, errs, rows



# ----------------------------------------------------------------------
# phase 15: MoE training and tensor-parallel training (ROADMAP A10 item
# 3, and item 4 in the head layout)
# ----------------------------------------------------------------------
def t15_flash_parity(fa, dev) -> dict:
    """(d) The flash kernel against its plain version at the layouts the
    new paths launch it with (``T15_FLASH``), f32, causal, T = S = 2048,
    output and lse within phase 3's f32 tolerance."""
    errs = {}
    for tag, sh in T15_FLASH.items():
        g = torch.Generator(device=dev).manual_seed(17)
        q, k, v = (torch.randn((sh["b"], T15_SEQ, h, sh["d"]), generator=g,
                               device=dev).transpose(1, 2)
                   for h in (sh["h"], sh["hkv"], sh["hkv"]))
        n = fa.LAUNCHES["flash_attention"]
        out, lse = fa.flash_attention(q, k, v, causal=True)
        ref, ref_lse = fa.flash_attention_ref(q, k, v, causal=True)
        torch.cuda.synchronize()
        if fa.LAUNCHES["flash_attention"] != n + 1:
            fail(f"t15 flash {tag}: the kernel did not launch")
        err = max((out - ref).abs().max().item(),
                  (lse - ref_lse).abs().max().item())
        print(f"t15 parity flash {tag} (B {sh['b']}, H {sh['h']} / H_kv "
              f"{sh['hkv']}, D {sh['d']}, T=S={T15_SEQ}, f32): max |kernel "
              f"- plain| {err:.3e} (tol {TOL[torch.float32]})", flush=True)
        if not err <= TOL[torch.float32]:
            fail(f"t15 flash {tag}: {err} > {TOL[torch.float32]}")
        errs[tag] = err
        del q, k, v, out, lse, ref, ref_lse
    torch.cuda.empty_cache()
    return errs


def t15_flat(tree, pre="") -> dict:
    """A nested dict's leaves by path (``a/b/c``)."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(t15_flat(v, pre + k + "/"))
        else:
            out[pre + k] = v
    return out


def t15_layers(params) -> dict:
    """Each MoE layer's router address -> its layer index (route events
    carry the address)."""
    return {layer["mlp"]["router"].data_ptr(): li
            for li, layer in enumerate(params["blocks"])}


def t15_flips(cfg, ev_a, ev_b, layers_a, layers_b, tag, labels) -> dict:
    """Two recorded runs of one batch (``MoeRecorder``), route event by
    route event: the rows whose top-k set or kept set differ.  The first
    such row (in event, row order) must be a top-k set flip at a near-tie
    (``b``'s relative gate gap below MOE_TIE f32): a keep-only difference
    with no set flip before it would be a capacity count that differs.
    Every flip is printed with its gap.  Returns {layer: experts whose
    membership or slot differs in some row}: the slices the gradient
    gate leaves out (the rule of phase 11: where no routing decision
    differs, the two runs compute one function)."""
    n_exp = cfg.moe.experts_padded(1)
    ra = [e for e in ev_a if e["kind"] == "route"]
    rb = [e for e in ev_b if e["kind"] == "route"]
    if len(ra) != len(rb):
        fail(f"t15 {tag}: {len(ra)} vs {len(rb)} routing calls")
    affected, shown, first, n_rows = {}, [], None, 0
    for i, (x, y) in enumerate(zip(ra, rb)):
        li = layers_a[x["router"]]
        if layers_b[y["router"]] != li:
            fail(f"t15 {tag}: routing call {i} is layer {li} in one run and "
                 f"{layers_b[y['router']]} in the other")
        (mx, kx), (my, ky) = route_sets(x, n_exp), route_sets(y, n_exp)
        dset, diff = mx != my, (mx != my) | (kx != ky)
        rows = torch.nonzero(diff.any(1)).flatten()
        if not len(rows):
            continue
        n_rows += len(rows)
        affected.setdefault(li, set()).update(
            torch.nonzero(diff.any(0)).flatten().tolist())
        if first is None:
            r = int(rows[0])
            first = {"call": i, "layer": li, "row": r,
                     "set": bool(dset[r].any()), "gap": float(y["gap"][r]),
                     f"gap_{labels[0]}": float(x["gap"][r])}
        shown += [f"{li}:{int(r)}:{'set' if dset[r].any() else 'keep'}:"
                  f"{float(y['gap'][r]):.2e}" for r in rows[:4]]
    print(f"t15 {tag} routing ({labels[0]} vs {labels[1]}): {n_rows} rows "
          f"differ over {len(ra)} routing calls; first "
          + (json.dumps(first) if first else "none")
          + f"; (layer:row:kind:gap) {' '.join(shown[:24])}; experts left "
          f"out of the gradient gate {({k: sorted(v) for k, v in affected.items()})}",
          flush=True)
    if first is not None and not (first["set"]
                                  and first["gap"] < MOE_TIE[torch.float32]):
        fail(f"t15 {tag}: the first routing difference is not a top-k flip "
             f"at a near-tie: {first}")
    return affected


def t15_grad_gate(tag, got: dict, want: dict, affected: dict, tol: float,
                  n_experts: int = 0) -> dict:
    """Each leaf's max |got - want| over its largest |want| within ``tol``,
    the routers of layers with a routing difference and the experts it
    touched (``t15_flips``) left out and printed; with ``n_experts``
    (padded experts past it) their router columns and expert tensors
    must be exactly zero in both.  Returns {leaf: error}."""
    errs, left = {}, {}
    for key, w in want.items():
        a = got[key]
        if a.shape != w.shape:
            fail(f"t15 {tag}: {key} {tuple(a.shape)} vs {tuple(w.shape)}")
        diff = (a - w).abs()
        name = key.rsplit("/", 1)[-1]
        if key.startswith("blocks/mlp/") and "shared" not in key and affected:
            mask = torch.zeros_like(diff, dtype=torch.bool)
            for li, experts in affected.items():
                if name == "router":
                    mask[li] = True
                else:
                    mask[li, sorted(experts)] = True
            if mask.any():
                left[key] = diff[mask].max().item() / max(
                    w.abs().max().item(), 1e-30)
                diff = diff.masked_fill(mask, 0)
        errs[key] = diff.max().item() / max(w.abs().max().item(), 1e-30)
        if n_experts and key.startswith("blocks/mlp/") and name in (
                "router", "wu", "wg", "wd") and "shared" not in key:
            pad = a[..., n_experts:] if name == "router" else a[:, n_experts:]
            padw = w[..., n_experts:] if name == "router" else w[:, n_experts:]
            if pad.abs().max().item() != 0 or padw.abs().max().item() != 0:
                fail(f"t15 {tag}: padded experts' {key} gradient is not 0")
    worst = max(errs, key=errs.get)
    print(f"t15 {tag} gradients: worst leaf {worst} {errs[worst]:.3e} (tol "
          f"{tol}); left out for routing differences "
          f"{({k: f'{v:.3e}' for k, v in left.items()})}", flush=True)
    bad = {k: v for k, v in errs.items() if not v <= tol}
    if bad:
        fail(f"t15 {tag}: gradients beyond {tol}: {bad}")
    return errs


def t15_recount(cfg, events, tag) -> int:
    """Every route event's kept pairs recounted on the host: slots in
    token-major order (token, then choice) per expert, kept below the
    capacity ``int(n k cf / E) + 1``; must equal what the card kept.
    Returns the pairs dropped."""
    m = cfg.moe
    e_pad, dropped = m.experts_padded(1), 0
    for e in events:
        if e["kind"] != "route":
            continue
        idx = e["idx"].long()
        n, k = idx.shape
        flat = idx.reshape(-1)
        pos = torch.nn.functional.one_hot(flat, e_pad).cumsum(0)[
            torch.arange(n * k), flat] - 1
        kept = (pos < int(n * k * m.capacity_factor / e_pad) + 1).view(n, k)
        if not torch.equal(kept, e["kept"]):
            fail(f"t15 {tag}: the card kept other pairs than the token-major "
                 f"count ({int((kept != e['kept']).sum())} of {n * k})")
        dropped += int((~kept).sum())
    return dropped


def t15_grads(grads, cfg=None, tp: int = 1) -> dict:
    """Row 0 of ``loss_and_grad``'s stacked gradients, as the global
    tree's leaves by path (``weights.unshard`` at tp > 1)."""
    from repro_torch.tree import tree_map
    from repro_torch.weights import unshard

    g0 = tree_map(lambda g: g[0], grads)
    return t15_flat(unshard(g0, cfg, tp) if tp > 1 else g0)


def t15_moe_train(fa, arch, dev) -> tuple:
    """(a) One MoE config at published width, ``T15_MOE``: the kernel
    forward's loss and gradients against the plain forward's
    (``attn_impl="ref"``) on the same weights and batch, routing
    recorded in both (``t15_flips``; loss rtol 1e-5, gradients 1e-4 of
    each leaf's largest where no routing decision differs; the padded
    experts' gradients exactly 0), then one AdamW step through
    ``build_trainer``'s ``Trainer``, recorded: pairs must drop; every
    routing call's kept pairs recounted (``t15_recount``).  Returns
    (flash launches, figures)."""
    from repro_torch.launch.train import build_trainer
    from repro_torch.models import lm
    from repro_torch.train import grad as tgrad
    from repro_torch.tree import leaves

    _free(dev)
    t0 = time.monotonic()
    tr = build_trainer(arch, global_batch=T15_MOE["rows"],
                       microbatches=T15_MOE["mb"], device=dev, seed=0,
                       n_layers=T15_MOE["layers"], seq_len=T15_SEQ)
    cfg, params = tr.cfg, tr.state["params"]
    n_params = sum(p.numel() for p in leaves(params))
    init_s = time.monotonic() - t0
    batch = tr.data.batch(0, device=dev)
    layers = t15_layers(params)
    runs, n0 = {}, fa.LAUNCHES["flash_attention"]
    for impl in ("kernel", "ref"):
        with MoeRecorder(cfg) as rec:
            loss, grads, _ = tgrad.loss_and_grad(
                lm.loss_fn, params, batch, tr.ctx.with_(attn_impl=impl), cfg)
        runs[impl] = (float(loss[0]), t15_grads(grads), rec.done())
        del grads
    cmp_launches = fa.LAUNCHES["flash_attention"] - n0
    tag = f"moe train {cfg.name}"
    cmp_drops = t15_recount(cfg, runs["kernel"][2], tag) // 2     # remat
    affected = t15_flips(cfg, runs["kernel"][2], runs["ref"][2], layers,
                         layers, tag, ("kernel", "plain"))
    lk, lr_ = runs["kernel"][0], runs["ref"][0]
    ltol, gtol = T15_TOL["plain"]
    if not abs(lk - lr_) <= ltol * abs(lr_):
        fail(f"t15 {tag}: loss kernel {lk} vs plain {lr_}")
    m = cfg.moe
    errs = t15_grad_gate(tag, runs["kernel"][1], runs["ref"][1], affected,
                         gtol, m.num_experts if m.padded_experts else 0)
    del runs
    _free(dev)
    n1 = fa.LAUNCHES["flash_attention"]
    with MoeRecorder(cfg) as rec:
        st = tr.step(0)
    step_launches = fa.LAUNCHES["flash_attention"] - n1
    peak = _peak_gb(dev)
    events = rec.done()
    t15_recount(cfg, events, tag)
    drops = [0] * cfg.n_layers
    for e in events:
        if e["kind"] == "route":
            drops[layers[e["router"]]] += int((~e["kept"]).sum())
    drops = [d // 2 for d in drops]           # each layer runs twice (remat)
    predict = cfg.n_layers * 2 + cfg.n_layers * T15_MOE["mb"] * 2
    launches = cmp_launches + step_launches
    tokens = T15_MOE["rows"] * T15_SEQ
    cap = int(tokens // T15_MOE["mb"] * m.top_k * m.capacity_factor
              / m.experts_padded(1)) + 1
    figs = {"loss": st["loss"], "grad_norm": st["grad_norm"],
            "step_s": st["seconds"], "tok_s": tokens / st["seconds"],
            "peak_gb": peak, "params_b": n_params / 1e9,
            "drops_per_layer": drops, "capacity": cap,
            "pairs_per_layer": tokens * m.top_k,
            "drops_in_the_comparison": cmp_drops, "flash_launches": launches,
            "predicted": predict, "loss_kernel_vs_plain": abs(lk - lr_),
            "init_s": init_s}
    print(f"t15 {tag}: {cfg.n_layers} layers at published width (d_model "
          f"{cfg.d_model}, {m.num_experts} experts (padded "
          f"{m.experts_padded(1)}) top-{m.top_k} of ff {m.expert_ff}, shared "
          f"ff {m.shared_ff}, capacity factor {m.capacity_factor}), "
          f"{n_params / 1e9:.3f} B params f32 + AdamW; {json.dumps(figs)}; "
          f"ln vocab {math.log(cfg.vocab):.3f}", flush=True)
    if not (math.isfinite(st["loss"]) and math.isfinite(st["grad_norm"])):
        fail(f"t15 {tag}: loss {st['loss']} grad_norm {st['grad_norm']}")
    if not sum(drops) > 0:
        fail(f"t15 {tag}: no pair dropped at capacity factor "
             f"{m.capacity_factor}")
    if launches != predict:
        fail(f"t15 {tag}: flash launches {launches} != predicted {predict}")
    del tr, params
    _free(dev)
    return launches, {"errs": max(errs.values()), **figs}


def t15_tp(fa, arch, disp, dev) -> tuple:
    """(b) One config at published width, ``T15_TP``: ``loss_and_grad`` at
    TP 4 (posh, the stacked team, sequence parallelism, the TP layout of
    ``weights.shard_for_tp``) against tp = 1 on the same weights and
    batch (``T15_TOL["tp"]``); under ``alltoall``, whose routing of each
    PE's own sequence shard differs from tp = 1 under drops by design,
    against its own plain forward at TP 4 (``attn_impl="ref"``,
    ``T15_TOL["plain"]``).  For a MoE config the routing rule of (a),
    PE 0's rows recorded (every PE's under alltoall).  Returns (the TP
    kernel run's flash launches, figures)."""
    from repro_torch import configs
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.train import cut_layers
    from repro_torch.models import lm
    from repro_torch.parallel import ParallelCtx
    from repro_torch.train import grad as tgrad
    from repro_torch.tree import leaves
    from repro_torch.weights import shard_for_tp

    _free(dev)
    tp = T15_TP["tp"]
    cfg = cut_layers(configs.get(arch), T15_TP["layers"])
    f32 = dict(remat=True, param_dtype=torch.float32,
               compute_dtype=torch.float32)
    params = lm.init(torch.Generator(device=dev).manual_seed(0), cfg,
                     device=dev)
    n_params = sum(p.numel() for p in leaves(params))
    batch = SyntheticLM(vocab=cfg.vocab, seq_len=T15_SEQ,
                        global_batch=T15_TP["rows"]).batch(0, device=dev)
    ctx4 = ParallelCtx(tp_size=tp, backend=T15_TP["backend"],
                       moe_dispatch=disp, **f32)
    a2a = disp == "alltoall"
    want, ctxw = (f"tp{tp} plain", ctx4.with_(attn_impl="ref")) if a2a \
        else ("tp1", ParallelCtx(**f32))
    got = f"tp{tp}"
    p4 = tgrad.trainable(lm.unstack(shard_for_tp(params, cfg, tp)))
    out, recs, lays = {}, {}, {}
    for tag, ctx in ((got, ctx4), (want, ctxw)):
        p = p4 if ctx.tp_size > 1 else tgrad.trainable(lm.unstack(params))
        lays[tag] = t15_layers(p) if cfg.moe else {}
        ctx.tp_comm.reset_stats()
        n = fa.LAUNCHES["flash_attention"]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        with (MoeRecorder(cfg, per_pe=a2a) if cfg.moe
              else contextlib.nullcontext()) as rec:
            loss, grads, _ = tgrad.loss_and_grad(lm.loss_fn, p, batch, ctx,
                                                 cfg)
            torch.cuda.synchronize()
        secs = time.monotonic() - t0
        out[tag] = {"loss": loss.reshape(-1), "seconds": secs,
                    "launches": fa.LAUNCHES["flash_attention"] - n,
                    "grads": t15_grads(grads, cfg, ctx.tp_size),
                    "calls": {op: s["calls"] for op, s in
                              ctx.tp_comm.stats().items()}}
        recs[tag] = rec.done() if cfg.moe else []
        del p, grads
    del p4
    peak = _peak_gb(dev)
    a, b = out[got], out[want]
    tag = f"tp train {cfg.name} ({T15_TP['backend']}, {disp})"
    affected = t15_flips(cfg, recs[got], recs[want], lays[got], lays[want],
                         tag, (got, want)) if cfg.moe else {}
    ltol, gtol = T15_TOL["plain" if a2a else "tp"]
    l4, l1 = a["loss"], float(b["loss"][0])
    if not bool((l4 == l4[0]).all()) or not abs(float(l4[0]) - l1) <= \
            ltol * abs(l1):
        fail(f"t15 {tag}: loss {got} {l4.tolist()} vs {want} {l1}")
    errs = t15_grad_gate(tag, a["grads"], b["grads"], affected, gtol)
    predict = cfg.n_layers * 2
    figs = {"loss_tp": float(l4[0]), f"loss_{want}": l1,
            "seconds_tp": a["seconds"], f"seconds_{want}": b["seconds"],
            "peak_gb": peak, "params_b": n_params / 1e9,
            "collectives_tp": a["calls"], "flash_launches_tp": a["launches"],
            f"flash_launches_{want}": b["launches"], "predicted": predict,
            "worst_grad_err": max(errs.values())}
    print(f"t15 {tag}: {cfg.n_layers} of {configs.get(arch).n_layers} layers "
          f"at published width, {n_params / 1e9:.3f} B params f32, "
          f"{T15_TP['rows']} x {T15_SEQ} tokens, loss_and_grad at TP {tp} "
          f"on the stacked team vs {want}; {json.dumps(figs)}", flush=True)
    if a["launches"] != predict or b["launches"] != (0 if a2a else predict):
        fail(f"t15 {tag}: flash launches {a['launches']} / {b['launches']}, "
             f"predicted {predict} a kernel run (one a layer for every PE, "
             f"x 2 remat), 0 a plain one")
    del out, params
    _free(dev)
    return a["launches"], figs


def t15_stage(fa, dev) -> tuple:
    """Phase 15: (d), (a) for both MoE configs, (b) for qwen3-8b and
    qwen3-moe (einsum) against tp = 1 and qwen2-moe (alltoall) against
    its plain run; returns (MoE training flash launches, TP training
    flash launches, the flash parity errors at the new layouts)."""
    errs = t15_flash_parity(fa, dev)
    moe = sum(t15_moe_train(fa, arch, dev)[0]
              for arch in ("qwen3-moe-30b-a3b", "qwen2-moe-a2.7b"))
    tp = sum(t15_tp(fa, arch, disp, dev)[0]
             for arch, disp in (("qwen3-8b", "einsum"),
                                ("qwen3-moe-30b-a3b", "einsum"),
                                ("qwen2-moe-a2.7b", "alltoall")))
    print(f"t15: flash launches MoE training {moe}, TP training {tp}",
          flush=True)
    return moe, tp, errs




# ----------------------------------------------------------------------
# phase 16: TP training of the remaining families, the ctx attention
# layout, and the contiguous-cache decode at tp > 1
# ----------------------------------------------------------------------
def t16_ctx(tp: int = 1, backend: str = "xla", dtype=torch.float32,
            remat: bool = True):
    from repro_torch.parallel import ParallelCtx
    return ParallelCtx(tp_size=tp, backend=backend, remat=remat,
                       param_dtype=dtype, compute_dtype=dtype)


def t16_cfg(c: dict, smoke: bool):
    from repro_torch import configs
    from repro_torch.launch.train import cut_layers
    return cut_layers(configs.get_smoke(c["arch"]) if smoke
                      else configs.get(c["arch"]), 0 if smoke else c["layers"])


def t16_batch(cfg, rows: int, seq: int, dev, seed: int = 7) -> dict:
    """Seeded tokens (rows, seq + 1), and whisper's unit-normal frames /
    the vlm's image embeddings (``img_tokens`` rows), on ``dev``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab, (rows, seq + 1),
                                     generator=g, device=dev)}
    key = {"encdec": ("frames", cfg.enc_frames),
           "vlm": ("img_embeds", cfg.img_tokens)}.get(cfg.family)
    if key:
        batch[key[0]] = torch.randn((rows, key[1], cfg.d_model), generator=g,
                                    device=dev)
    return batch


def t16_lg(fa, params, cfg, ctx, batch) -> dict:
    """``loss_and_grad`` of ``params`` (the global ones; at tp > 1 in
    ``weights.shard_for_tp``'s layout, dropped after) at ``ctx``: the
    loss shown, the global gradients by path (``t15_grads``), the flash
    launches and the seconds."""
    from repro_torch.models import lm, registry
    from repro_torch.train import grad as tgrad
    from repro_torch.weights import shard_for_tp

    p = tgrad.trainable(lm.unstack(shard_for_tp(params, cfg, ctx.tp_size)))
    n = fa.LAUNCHES["flash_attention"]
    if batch["tokens"].device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.monotonic()
    loss, grads, _ = tgrad.loss_and_grad(registry.build(cfg).loss_fn, p,
                                         batch, ctx, cfg)
    flat = t15_grads(grads, cfg, ctx.tp_size)
    if batch["tokens"].device.type == "cuda":
        torch.cuda.synchronize()
    out = {"loss": loss.reshape(-1), "grads": flat,
           "launches": fa.LAUNCHES["flash_attention"] - n,
           "seconds": time.monotonic() - t0}
    del p, grads
    return out


def t16_launches(tag, got: int, want: int, dev) -> None:
    """Fail unless ``got`` flash launches are ``want`` (counted on the
    card only: a CPU rehearsal runs the plain versions)."""
    if torch.device(dev).type == "cuda" and got != want:
        fail(f"t16 {tag}: flash launches {got} != {want}")


def t16_exact(params, cfg, batch) -> dict:
    """The step's loss and global gradients in f64 at tp = 1 (plain
    attention, autograd alone): the yardstick the f32 runs of the
    recurrent families are held to."""
    from repro_torch.models import lm, registry
    from repro_torch.train import grad as tgrad
    from repro_torch.tree import ref_tree, tree_map

    p = tgrad.trainable(lm.unstack(tree_map(lambda t: t.double(), params)))
    ctx = t16_ctx(dtype=torch.float64).with_(attn_impl="ref")
    loss = registry.build(cfg).loss_fn(p, batch, ctx, cfg)
    loss.backward()
    grads = ref_tree(p, lambda g: torch.stack([t.grad for t in g])
                     if isinstance(g, list) else g.grad)
    out = {"loss": loss.detach().reshape(-1), "grads": t15_flat(grads)}
    del p, grads
    return out


def t16_train_gate(tag, got: dict, want: dict, exact=None) -> float:
    """TP against tp = 1: every PE's loss equal, within rtol 2e-5 of tp =
    1's; each leaf's gradient within 5e-4 of its largest
    (``T15_TOL["tp"]``), or with ``exact`` (an f64 run of the step) TP's
    and tp = 1's each within ``T16_F64_TOL`` of the f64 gradients'
    largest.  Returns the worst leaf's error."""
    ltol, gtol = T15_TOL["tp"]
    lt, l1 = got["loss"], float(want["loss"][0])
    if not bool((lt == lt[0]).all()) or not abs(float(lt[0]) - l1) <= \
            ltol * abs(l1):
        fail(f"t16 {tag}: loss {lt.tolist()} vs tp = 1 {l1}")
    if exact is None:
        errs = t15_grad_gate(f"16 {tag}", got["grads"], want["grads"], {},
                             gtol)
        return max(errs.values())
    g64 = {k: v.float() for k, v in exact["grads"].items()}
    one = t15_grad_gate(f"16 {tag} tp = 1 vs f64", want["grads"], g64, {},
                        T16_F64_TOL)
    errs = t15_grad_gate(f"16 {tag} vs f64", got["grads"], g64, {},
                         T16_F64_TOL)
    print(f"t16 {tag}: worst leaf against the f64 step: TP "
          f"{max(errs.values()):.3e}, tp = 1 {max(one.values()):.3e}",
          flush=True)
    return max(errs.values())


def t16_gather_logits(lg: torch.Tensor) -> torch.Tensor:
    """A decode step's logits as (b, V): the vocab shards (tp, b, V/tp)
    concatenated at tp > 1."""
    return lg if lg.dim() == 2 else lg.permute(1, 0, 2).flatten(1)


def t16_decode(params, cfg, ctx, prompt, new: int, dev, extra=None):
    """``prompt`` (b, n) fed through the decode one token at a time, then
    ``new`` greedy tokens: (picks (b, n + new), logits (b, n + new, V),
    seconds).  ``extra``: whisper's encoder K/V or the vlm's image
    K/V."""
    from repro_torch.models import encdec, lm
    b, n = prompt.shape
    state = (encdec if cfg.family == "encdec" else lm).init_decode_state(
        cfg, ctx, b, n + new, device=dev)
    toks, logits = [], []
    sync = torch.device(dev).type == "cuda"
    if sync:
        torch.cuda.synchronize()
    t0 = time.monotonic()
    with torch.no_grad():
        tok = prompt[:, 0]
        for i in range(n + new):
            if i < n:
                tok = prompt[:, i]
            if cfg.family == "encdec":
                lg, state = encdec.decode_logits(params, tok, state, extra,
                                                 ctx, cfg)
            else:
                lg, state = lm.decode_logits(params, tok, state, ctx, cfg,
                                             img_kv=extra)
            lg = t16_gather_logits(lg).float()
            tok = lg.argmax(-1)
            toks.append(tok)
            logits.append(lg)
    if sync:
        torch.cuda.synchronize()
    return torch.stack(toks, 1), torch.stack(logits, 1), \
        time.monotonic() - t0


def t16_streams(tag, got, want, fed: int, rule: str) -> int:
    """TP's picks against tp = 1's over the same inputs: at each fed
    position, and in the greedy part up to the first difference (the
    histories part there), a difference passes only at a near-tie of
    the two computations' logits: the TP pick within DELTA, the largest
    gap between them, of tp = 1's top and DELTA at most F32_NEAR_TIE
    (``rule`` "f32": every state f32, rwkv6's) or NEAR_TIE_DELTA of
    |top| (or a top-2 margin of one bf16 ulp: "bf16", a decode that
    reads bf16 KV caches or Mamba conv buffers back, whatever its
    compute dtype).  Returns the differences."""
    (ta, la), (tb, lb) = got, want
    bad, n = [], 0
    for r in range(ta.shape[0]):
        for j in range(ta.shape[1]):
            if int(ta[r, j]) == int(tb[r, j]):
                continue
            n += 1
            vals, _ = lb[r, j].topk(2)
            top, mg = vals[0].item(), (vals[0] - vals[1]).item()
            gap = top - lb[r, j, int(ta[r, j])].item()
            delta = (la[r, j] - lb[r, j]).abs().max().item()
            lim = F32_NEAR_TIE if rule == "f32" else NEAR_TIE_DELTA
            ok = gap <= delta <= lim * abs(top) or (
                rule == "bf16" and mg <= bf16_ulp(top))
            verdict = "near-tie" if ok else "NOT a near-tie"
            print(f"t16 {tag}: row {r} position {j}: TP {int(ta[r, j])} vs "
                  f"tp = 1 {int(tb[r, j])}, top-2 margin {mg:.6g} at "
                  f"{top:.6g}, the TP token {gap:.6g} below, logits "
                  f"{delta:.6g} apart ({verdict})", flush=True)
            if not ok:
                bad.append((r, j))
            if j >= fed - 1:
                break               # the greedy histories part here
    if bad:
        fail(f"t16 {tag}: TP's stream leaves tp = 1's beyond a near-tie at "
             f"{bad}")
    return n


@contextlib.contextmanager
def t16_capture(fa, store: dict):
    """Record (a copy of) the flash kernel's first call's arguments."""
    real = fa.flash_attention

    def spy(q, k, v, **kw):
        if not store:
            store.update(q=q.clone(), k=k.clone(), v=v.clone(), kw=dict(kw))
        return real(q, k, v, **kw)
    fa.flash_attention = spy
    try:
        yield store
    finally:
        fa.flash_attention = real


def t16_visible_pairs(t: int, s: int, offsets) -> int:
    """(row, column) pairs a causal attention of ``t`` query rows at each
    of ``offsets`` over ``s`` keys computes."""
    return sum(min(o + i + 1, s) for o in offsets for i in range(t))


def t16_flash_time(fa, tag, q, k, v, kw, dev) -> dict:
    """Kernel, plain version, SDPA (an explicit boolean mask: every row's
    own causal offset; GQA) and the bound (operations over the pairs the
    mask leaves, f32) at one layout; the kernel == plain first."""
    import torch.nn.functional as F

    b, h, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    rows, stride = kw.get("pe_rows", 1), kw.get("pe_stride", 0)
    out, lse = fa.flash_attention(q, k, v, **kw)
    ref, ref_lse = fa.flash_attention_ref(q, k, v, **kw)
    err = max((out - ref).abs().max().item(),
              (lse - ref_lse).abs().max().item())
    if not err <= TOL[torch.float32]:
        fail(f"t16 flash {tag}: |kernel - plain| {err} > {TOL[torch.float32]}")
    pos = fa.query_positions(kw.get("q_offset", 0), t, dev, b, rows, stride)
    mask = fa.attention_mask(pos, torch.arange(s, device=dev), True, None, s)
    mask = mask.reshape((b if stride else 1, 1, t, s))
    offs = [kw.get("q_offset", 0) + (i // rows) * stride for i in range(b)]
    pairs = t16_visible_pairs(t, s, offs) * h
    flops = 4 * d * pairs
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * 4 + b * h * t * 4
    qc = q.contiguous()
    ms = time_ms(lambda: fa.flash_attention(q, k, v, **kw), dev)
    plain_ms = time_ms(lambda: fa.flash_attention_ref(q, k, v, **kw), dev)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qc, k, v, attn_mask=mask, enable_gqa=True), dev)
    bound_ms, by = bound_of(nbytes, flops, torch.float32)
    row = {"b": b, "h": h, "hkv": hkv, "t": t, "s": s, "d": d,
           "pe_rows": rows, "pe_stride": stride, "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": bound_ms, "bound_by": by, "flops": flops,
           "bytes": nbytes, **rates(ms, nbytes, flops, bound_ms)}
    print(f"t16 timing flash {tag} (f32, B {b}, H {h} / H_kv {hkv}, T {t}, "
          f"S {s}, D {d}, causal, batch row i at {kw.get('q_offset', 0)} + "
          f"(i // {rows}) * {stride}): |kernel - plain| {err:.3e}; kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa (boolean mask) "
          f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}: {flops:.3e} "
          f"flops over the {pairs} visible (row, column, head) triples, "
          f"{nbytes} bytes); {rate_text(row)}", flush=True)
    return row


def t16_minitron(fa, dev, smoke: bool = False) -> tuple:
    """(a) minitron-4b, f32, 2 of 32 layers, TP 16 under posh (24 heads:
    the ctx layout): ``loss_and_grad`` of 2 x 2048 tokens at TP 16 == tp
    = 1; one flash launch a layer for all 16 PEs (B 32, T 128 a PE, S
    2048, H 24 / 8, D 128, per-PE offsets), the kernel == plain on the
    step's own inputs; then a 64-token prompt through the decode and 32
    greedy tokens at TP 16 (the cache sequence-sharded, bf16) == tp = 1.
    Returns (flash launches, figures, the captured inputs)."""
    from repro_torch.models import lm
    from repro_torch.weights import shard_for_tp

    c = T16["minitron"]
    cfg = t16_cfg(c, smoke)
    tp = 4 if smoke else c["tp"]
    seq = 32 if smoke else c["seq"]
    _free(dev)
    params = lm.init(torch.Generator(device=dev).manual_seed(0), cfg,
                     device=dev, tp=tp)
    batch = t16_batch(cfg, c["rows"], seq, dev)
    one = t16_lg(fa, params, cfg, t16_ctx(), batch)
    cap = {}
    with t16_capture(fa, cap):
        run = t16_lg(fa, params, cfg, t16_ctx(tp, c["backend"]), batch)
    peak = _peak_gb(dev)
    tag = f"train {cfg.name} TP {tp} ({c['backend']}, ctx layout)"
    assert cfg.attn_layout(tp) == "ctx"
    err = t16_train_gate(tag, run, one)
    del one
    predict = 2 * cfg.n_layers                     # a layer, x 2 remat
    t16_launches(tag, run["launches"], predict, dev)
    want = (c["rows"] * tp, cfg.n_heads, seq // tp, cfg.head_dim)
    if cap and (tuple(cap["q"].shape) != want
                or cap["kw"].get("pe_stride") != seq // tp):
        fail(f"t16 {tag}: the flash call took q {tuple(cap['q'].shape)}, "
             f"{cap['kw']}, not {want} at per-PE offsets")
    n, new = (8, 8) if smoke else (c["prompt"], c["new"])
    prompt = batch["tokens"][:, :n]
    ctx1, ctxt = t16_ctx(remat=False), t16_ctx(tp, c["backend"], remat=False)
    del batch
    a = t16_decode(shard_for_tp(params, cfg, tp), cfg, ctxt, prompt, new,
                   dev)
    b = t16_decode(params, cfg, ctx1, prompt, new, dev)
    diff = t16_streams(f"decode {cfg.name} TP {tp}", a[:2], b[:2], n, "bf16")
    figs = {"loss": float(run["loss"][0]), "seconds_tp": run["seconds"],
            "worst_grad_err": err, "flash_launches": run["launches"],
            "predicted": predict, "peak_gb": peak, "decode_s_tp": a[2],
            "decode_s_tp1": b[2], "stream_diffs": diff,
            "cache_rows_a_pe": -(-(n + new) // tp)}
    print(f"t16 (a) {cfg.name}: {cfg.n_layers} layers at published width, "
          f"f32, {c['rows']} x {seq} tokens at TP {tp} == tp = 1; decode "
          f"{n} + {new} tokens a row at TP {tp} == tp = 1 ({diff} "
          f"differences); row 0's new tokens {a[0][0, n:].tolist()}; "
          f"{json.dumps(figs)}", flush=True)
    del params, a, b
    _free(dev)
    return run["launches"], figs, cap


def t16_rwkv(fa, dev, smoke: bool = False) -> dict:
    """(b) rwkv6-3b, f32, 2 of 32 layers, TP 4 under posh (12 of the 48
    padded heads a PE, the 8 ghost heads on PE 3): ``loss_and_grad`` ==
    tp = 1 (the loss; the gradients, TP's and tp = 1's, each held to an
    f64 run of the step: ``T16_F64_TOL``); 16 decoded tokens (after an
    8-token prompt) == tp = 1's."""
    from repro_torch.models import lm
    from repro_torch.weights import shard_for_tp

    c = T16["rwkv"]
    cfg = t16_cfg(c, smoke)
    tp, seq = c["tp"], 32 if smoke else c["seq"]
    _free(dev)
    params = lm.init(torch.Generator(device=dev).manual_seed(0), cfg,
                     device=dev, tp=tp)
    batch = t16_batch(cfg, c["rows"], seq, dev)
    one = t16_lg(fa, params, cfg, t16_ctx(), batch)
    run = t16_lg(fa, params, cfg, t16_ctx(tp, c["backend"]), batch)
    tag = f"train {cfg.name} TP {tp} ({c['backend']})"
    err = t16_train_gate(tag, run, one, t16_exact(params, cfg, batch))
    peak = _peak_gb(dev)
    del one
    n, new = c["prompt"], c["new"]
    prompt = batch["tokens"][:, :n]
    a = t16_decode(shard_for_tp(params, cfg, tp), cfg,
                   t16_ctx(tp, c["backend"], remat=False), prompt, new, dev)
    b = t16_decode(params, cfg, t16_ctx(remat=False), prompt, new, dev)
    diff = t16_streams(f"decode {cfg.name} TP {tp}", a[:2], b[:2], n, "f32")
    figs = {"loss": float(run["loss"][0]), "seconds_tp": run["seconds"],
            "worst_grad_err_vs_f64": err, "peak_gb": peak,
            "decode_s_tp": a[2], "stream_diffs": diff,
            "heads_a_pe": (cfg.rwkv_padded_heads or cfg.n_heads) // tp}
    print(f"t16 (b) {cfg.name}: {json.dumps(figs)}; row 0's new tokens "
          f"{a[0][0, n:].tolist()}", flush=True)
    del params, a, b, batch
    _free(dev)
    return figs


def t16_zamba(fa, dev, smoke: bool = False) -> tuple:
    """(c) zamba2-7b, f32, 12 of 81 layers (2 applications of the shared
    block), TP 4 under xla: ``loss_and_grad`` == tp = 1 (the loss; the
    gradients held to an f64 run, as (b)'s; the flash kernel at the
    stacked layout, 8 heads of 112 a PE, one launch an application); 8
    decoded tokens (after 8 fed) == tp = 1's decode,
    the reference's one shared cache at both.  Returns (flash launches
    of the TP run, figures)."""
    from repro_torch.models import lm
    from repro_torch.weights import shard_for_tp

    c = T16["zamba"]
    cfg = t16_cfg(c, smoke)
    tp, seq = c["tp"], 32 if smoke else c["seq"]
    _free(dev)
    params = lm.init(torch.Generator(device=dev).manual_seed(0), cfg,
                     device=dev, tp=tp)
    batch = t16_batch(cfg, c["rows"], seq, dev)
    one = t16_lg(fa, params, cfg, t16_ctx(), batch)
    run = t16_lg(fa, params, cfg, t16_ctx(tp, c["backend"]), batch)
    tag = f"train {cfg.name} TP {tp} ({c['backend']})"
    err = t16_train_gate(tag, run, one, t16_exact(params, cfg, batch))
    peak = _peak_gb(dev)
    predict = cfg.n_layers // cfg.shared_attn_every   # the shared block
    t16_launches(tag, run["launches"], predict, dev)
    t16_launches(tag + " tp = 1", one["launches"], predict, dev)
    del one
    n, new = c["prompt"], c["new"]
    prompt = batch["tokens"][:, :n]
    a = t16_decode(shard_for_tp(params, cfg, tp), cfg,
                   t16_ctx(tp, c["backend"], remat=False), prompt, new, dev)
    b = t16_decode(params, cfg, t16_ctx(remat=False), prompt, new, dev)
    diff = t16_streams(f"decode {cfg.name} TP {tp}", a[:2], b[:2], n, "bf16")
    figs = {"loss": float(run["loss"][0]), "seconds_tp": run["seconds"],
            "worst_grad_err_vs_f64": err, "peak_gb": peak,
            "flash_launches": run["launches"], "predicted": predict,
            "decode_s_tp": a[2], "stream_diffs": diff}
    print(f"t16 (c) {cfg.name}: {cfg.n_layers} layers, {json.dumps(figs)}; "
          f"row 0's new tokens {a[0][0, n:].tolist()}", flush=True)
    del params, a, b, batch
    _free(dev)
    return run["launches"], figs


def t16_whisper(fa, dev, smoke: bool = False) -> tuple:
    """(d) whisper-base, f32, all 6 + 6 layers, the vocab padded to 16:
    ``loss_and_grad`` of 2 x (1500 frames, 448 + 1 tokens) at TP 4 (head
    layout) and TP 16 (ctx layout, 28 rows a PE; the encoder whole on
    every PE) == tp = 1; 32 decoded tokens at TP 4 (after 4 fed) == tp
    = 1's.  Returns (flash launches of the TP runs, figures)."""
    from repro_torch.models import encdec
    from repro_torch.weights import shard_for_tp

    c = T16["whisper"]
    cfg = t16_cfg(c, smoke)
    tps = (c["tp"], 8 if smoke else c["tp_ctx"])
    seq = 32 if smoke else c["seq"]
    _free(dev)
    params = encdec.init(torch.Generator(device=dev).manual_seed(0), cfg,
                         device=dev, tp=max(tps))
    batch = t16_batch(cfg, c["rows"], seq, dev)
    one = t16_lg(fa, params, cfg, t16_ctx(), batch)
    predict = 3 * 2 * cfg.n_layers     # enc self, dec self, cross; remat
    figs, launches = {}, 0
    for tp in tps:
        run = t16_lg(fa, params, cfg, t16_ctx(tp, c["backend"]), batch)
        layout = cfg.attn_layout(tp)
        tag = f"train {cfg.name} TP {tp} ({c['backend']}, {layout} layout)"
        figs[f"tp{tp}"] = {"loss": float(run["loss"][0]),
                           "seconds": run["seconds"],
                           "worst_grad_err": t16_train_gate(tag, run, one),
                           "flash_launches": run["launches"]}
        t16_launches(tag, run["launches"], predict, dev)
        launches += run["launches"]
        del run
    t16_launches("whisper tp = 1", one["launches"], predict, dev)
    figs["peak_gb"] = _peak_gb(dev)
    del one
    n, new, tp = c["prompt"], c["new"], c["tp"]
    prompt = batch["tokens"][:, :n]
    ctx1, ctxt = t16_ctx(remat=False), t16_ctx(tp, c["backend"], remat=False)
    pt = shard_for_tp(params, cfg, tp)
    with torch.no_grad():
        kv1 = encdec.encoder_cross_kv(params, encdec.encode(
            params, batch["frames"], ctx1, cfg), ctx1, cfg)
        kvt = encdec.encoder_cross_kv(pt, encdec.encode(
            pt, batch["frames"], ctxt, cfg), ctxt, cfg)
    a = t16_decode(pt, cfg, ctxt, prompt, new, dev, extra=kvt)
    b = t16_decode(params, cfg, ctx1, prompt, new, dev, extra=kv1)
    figs["stream_diffs"] = t16_streams(f"decode {cfg.name} TP {tp}", a[:2],
                                       b[:2], n, "bf16")
    figs["decode_s_tp"] = a[2]
    print(f"t16 (d) {cfg.name}: {json.dumps(figs)}; row 0's new tokens "
          f"{a[0][0, n:].tolist()}", flush=True)
    del params, pt, kv1, kvt, a, b, batch
    _free(dev)
    return launches, figs


def t16_vlm(fa, dev, smoke: bool = False) -> tuple:
    """(e) llama-3.2-vision-90b, bf16, 1 of 20 groups (4 dense + 1 cross
    layer), TP 4 under posh, both gates non-zero: ``prefill`` of 1 x
    1024 tokens against 1601 image rows, then 16 tokens through
    ``decode_logits`` from its pick, each PE with its KV heads of the
    image K/V, held to tp = 1 by the bf16 near-tie rule.  Returns (flash
    launches of the TP prefill, figures)."""
    from repro_torch.models import lm
    from repro_torch.models.attention import cross_kv
    from repro_torch.weights import shard_for_tp

    c = T16["vlm"]
    cfg = t16_cfg(c, smoke)
    tp, bf = c["tp"], torch.bfloat16
    seq = 32 if smoke else c["prompt"]
    ng = cfg.n_layers // cfg.cross_attn_every
    _free(dev)
    params = lm.init(torch.Generator(device=dev).manual_seed(0), cfg,
                     dtype=bf, device=dev, tp=tp)
    for name, vals in XATTN_GATES.items():
        params["cross"][name].copy_(torch.tensor(vals[:ng], dtype=bf)[:, None])
    pt = shard_for_tp(params, cfg, tp)
    batch = t16_batch(cfg, c["rows"], seq - 1, dev)
    img = batch["img_embeds"].to(bf)
    prompt = batch["tokens"]
    runs = {}
    for key, p, ctx in (("tp", pt, t16_ctx(tp, c["backend"], bf, False)),
                        ("tp1", params, t16_ctx(1, "xla", bf, False))):
        n0 = fa.LAUNCHES["flash_attention"]
        with torch.no_grad():
            h = lm.prefill(p, prompt, ctx, cfg, img_embeds=img)
            lg = t16_gather_logits(lm.lm_head_logits(p["head"], h, ctx))
            pre = fa.LAUNCHES["flash_attention"] - n0
            kvs = [cross_kv(lm.layer(p["cross"], g)["xattn"],
                            lm.per_pe(img, ctx), ctx, cfg)
                   for g in range(ng)]
            img_kv = (torch.stack([k for k, _ in kvs]),
                      torch.stack([v for _, v in kvs]))
        first = lg.float().argmax(-1)
        toks, logits, sec = t16_decode(p, cfg, ctx, first[:, None], c["new"],
                                       dev, extra=img_kv)
        runs[key] = (torch.cat([first[:, None], toks], 1),
                     torch.cat([lg.float()[:, None], logits], 1), sec, pre)
        del h, kvs, img_kv
    peak = _peak_gb(dev)
    diff = t16_streams(f"prefill + decode {cfg.name} TP {tp}",
                       runs["tp"][:2], runs["tp1"][:2], 1, "bf16")
    figs = {"prefill_launches": runs["tp"][3], "predicted": cfg.n_layers,
            "decode_s_tp": runs["tp"][2], "stream_diffs": diff,
            "peak_gb": peak}
    for key in ("tp", "tp1"):
        t16_launches(f"vlm prefill {key}", runs[key][3], cfg.n_layers, dev)
    print(f"t16 (e) {cfg.name}: {ng} group(s) bf16, gates "
          f"{ {k: v[:ng] for k, v in XATTN_GATES.items()} }, 1 x {seq} "
          f"tokens against {cfg.img_tokens} image rows; {json.dumps(figs)}; "
          f"TP's tokens {runs['tp'][0][0].tolist()}", flush=True)
    launches = runs["tp"][3]
    del params, pt, runs, img
    _free(dev)
    return launches, figs


def t16_stage(fa, sc, dev) -> tuple:
    """Phase 16: (a)-(e), then the flash kernel timed at (a)'s captured
    ctx-layout call and at phase 15's layouts.  Returns (the TP runs'
    flash launches, the copy kernel's launches over the phase, the
    timing rows)."""
    c0 = sc.LAUNCHES["copy_blocked"]
    la, _, cap = t16_minitron(fa, dev)
    t16_rwkv(fa, dev)
    lc, _ = t16_zamba(fa, dev)
    ld, _ = t16_whisper(fa, dev)
    le, _ = t16_vlm(fa, dev)
    copies = sc.LAUNCHES["copy_blocked"] - c0
    print(f"t16: the copy kernel launched {copies} times over the phase: "
          f"the posh and xla backends move the stacked team's collectives "
          f"with tensor operations on the card (the pallas backend alone "
          f"stages them through the copy kernel)", flush=True)
    if copies:
        fail(f"t16: {copies} copy-kernel launches without the pallas backend")
    rows = {"minitron_tp16_ctx": t16_flash_time(fa, "minitron TP 16 ctx",
                                                cap["q"], cap["k"], cap["v"],
                                                cap["kw"], dev)}
    del cap
    for tag in T16_TIMED:
        sh = T15_FLASH[tag]
        g = torch.Generator(device=dev).manual_seed(17)
        q, k, v = (torch.randn((sh["b"], T15_SEQ, h, sh["d"]), generator=g,
                               device=dev).transpose(1, 2)
                   for h in (sh["h"], sh["hkv"], sh["hkv"]))
        rows[tag] = t16_flash_time(fa, tag, q, k, v, {"causal": True}, dev)
        del q, k, v
    torch.cuda.empty_cache()
    launches = la + lc + ld + le
    print(f"t16: flash launches over the TP runs {launches} (minitron {la}, "
          f"zamba2 {lc}, whisper {ld}, vlm prefill {le})", flush=True)
    return launches, copies, rows


# ----------------------------------------------------------------------
# phase 17: the paper's sweep, the checker on the card, the dry run
# ----------------------------------------------------------------------
PINGPONG = os.path.join(ROOT, "examples", "torch", "shmem_pingpong.py")
DRYRUN_PEAK_TOL = 0.20          # |predicted - measured| / measured
DRYRUN_TIMEOUT_S = 600


def pingpong_module():
    """``examples/torch/shmem_pingpong.py``, imported from its path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("shmem_pingpong", PINGPONG)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def posh_micro_stage(sc, dev, card: str) -> int:
    """(a) posh-micro at its full config on the stacked 8-PE team: every
    size x dtype through put, get, put_nbi + quiet and the local copy,
    then the K = 8 pipeline (nbi vs blocking), each under the default
    stager and the copy kernel's.  Gates: every output is its input
    rolled by the round's pairs, bit for bit; the copy stager's output
    == the default's; the copy kernel's launches == the staged rounds
    (``staged_rounds``) of every call.  Returns those launches."""
    from repro_torch import configs

    pp = pingpong_module()
    cfg = configs.get("posh-micro")
    torch.cuda.synchronize()
    sc.reset_launches()
    t0 = time.monotonic()
    rows = pp.sweep(cfg, dev)
    secs = time.monotonic() - t0
    launches = sc.LAUNCHES["copy_blocked"]
    bad = pp.failures(rows)
    if bad:
        fail(f"posh-micro: {len(bad)} cells disagree, first {bad[0]}")
    want = sum(r["expected_launches"] for r in rows)
    if launches != want or not launches:
        fail(f"posh-micro: copy launches {launches} != staged rounds {want}")
    print(f"posh-micro (the paper's Tables 1-2; {card}): {len(rows)} cells, "
          f"{len(cfg.buffer_sizes)} sizes {cfg.buffer_sizes[0]}.."
          f"{cfg.buffer_sizes[-1]} elements a PE x {cfg.dtypes} x "
          f"{pp.SWEEP_OPS} + the K = {pp.K} pipeline, {cfg.warmup} warm-ups "
          f"+ {cfg.repeats} repeats a cell, each under both stagers; every "
          f"output == its input rolled bit for bit, copy stager == default, "
          f"copy launches {launches} == staged rounds; {secs:.1f} s",
          flush=True)
    for stager in pp.STAGERS:
        print(pp.table(rows, stager), flush=True)
    return launches


def checker_stage(dev) -> dict:
    """(b) the port's shmemcheck armed on the card over a disaggregated
    1 + 1 handoff (put-with-signal tickets, AMO router and pools) with a
    hot-swap flip (signal batches, a cswap flip) on the smoke config, f32
    CUDA tensors.  Gates: 0 findings, the checker saw signal and atomic
    words, one flip, a handoff; then a deliberately racy put pair gives
    exactly one ww-race."""
    from repro_torch.analysis import shmemcheck
    from repro_torch.core import CommQueue, LocalTransport, SymmetricHeap
    from repro_torch.launch.serve import build_engine
    from repro_torch.models import lm
    from repro_torch.serve import Request

    t0 = time.monotonic()
    chk = shmemcheck.enable()
    chk.reset()
    try:
        eng, cfg = build_engine("qwen3-8b", config="smoke", dtype="f32",
                                device=dev, page_tokens=4, n_pages=32,
                                max_batch=3, prefill_chunk=3, disagg="1+1",
                                router="amo", seed=0)
        gen = torch.Generator(device=dev).manual_seed(SWAP_SEED)
        eng.begin_hot_swap(lm.init(gen, cfg, dtype=torch.float32, device=dev))
        prompts = [list(range(3, 9)), list(range(4, 10)), [7, 3, 99, 12]]
        eng.run([Request(rid=i, prompt=p, max_new=5)
                 for i, p in enumerate(prompts)], clock="tick")
        torch.cuda.synchronize()
        m, seen, found = eng.metrics(), chk.observed(), chk.report()
        if found:
            fail("checker: " + "; ".join(str(f) for f in found[:5]))
        if not (seen["signal_words"] and seen["atomic_words"]):
            fail(f"checker: armed but saw {seen}")
        if m["swap"]["flips"] != 1 or not m["handoff"]["handoff_tickets"]:
            fail(f"checker: swap {m['swap']}, handoff {m['handoff']}")
        chk.reset()
        heap = SymmetricHeap(("pe",))
        h = heap.alloc("buf", (8,), torch.float32)
        q = CommQueue("pe", heap.zeros_state(N_PE, device=dev),
                      transport=LocalTransport(N_PE))
        for value, offset in ((1.0, 0), (2.0, 2)):     # overlapping rows
            q.put_nbi(h, torch.full((N_PE, 3), value, device=dev), [(0, 1)],
                      offset=offset)
        q.quiet()
        rules = [f.rule for f in chk.report()]
        if rules != ["ww-race"]:
            fail(f"checker: the racy put pair gave {rules}, want one "
                 f"ww-race")
    finally:
        shmemcheck.disable()
    out = {"findings": 0, "seen": seen, "swap_flips": m["swap"]["flips"],
           "handoff_tickets": m["handoff"]["handoff_tickets"],
           "racy_pair": rules}
    print(f"checker on the card (disagg 1+1 amo + hot-swap flip, smoke f32): "
          f"0 findings, saw {seen}, swap {m['swap']}, handoff tickets "
          f"{m['handoff']['handoff_tickets']}; racy put pair -> {rules}; "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    return out


def dryrun_start():
    """(c)'s dry run of phase 6's exact step (gemma-2b f32, one PE, the
    global batch in its microbatches, remat, posh, ZeRO 0) on the meta
    device, in a process of its own that sees no card, started after
    phase 5: ~30 s of host Python beside the start of phase 6 (whose
    step it leaves as it was), done long before phase 17 reads it; the
    serving and comm phases' host-bound timings run without it."""
    code = (
        "import json, torch\n"
        "from repro_torch import configs\n"
        "from repro_torch.core.teams import Team\n"
        "from repro_torch.launch import dryrun\n"
        f"arch = {TRAIN['arch']!r}\n"
        "r = dryrun.lower_cell(arch, 'train_4k', "
        "team=Team(('data', 'model'), (1, 1)), backend='posh', zero=0, "
        f"microbatches={TRAIN['microbatches']}, "
        f"global_batch={TRAIN['global_batch']}, "
        "seq=configs.get(arch).max_seq, param_dtype=torch.float32, "
        "compute_dtype=torch.float32, verbose=False)\n"
        "print('DRYRUN ' + json.dumps(r))\n")
    env = dict(os.environ, PYTHONPATH=SRC, CUDA_VISIBLE_DEVICES="")
    log = tempfile.TemporaryFile(mode="w+")    # no pipe to fill meanwhile
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=log, stderr=subprocess.STDOUT, text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, log, time.monotonic()


def dryrun_stage(proc, log, t_start: float, base: dict, flash: int) -> dict:
    """(c) the dry run's FLOPs, bytes and predicted peak beside phase 6's
    measured step (``torch.cuda.max_memory_allocated``, no extra card
    run).  Gates: the predicted peak within 20% of the measured one; the
    flash kernel's meta calls == phase 6's ``flash`` launches."""
    try:
        proc.wait(timeout=DRYRUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        fail(f"dryrun: no result in {DRYRUN_TIMEOUT_S} s")
    log.seek(0)
    out = log.read()
    line = next((ln for ln in out.splitlines() if ln.startswith("DRYRUN ")),
                None)
    if proc.returncode != 0 or line is None:
        fail(f"dryrun: rc {proc.returncode}: {out[-2000:]}")
    r = json.loads(line[len("DRYRUN "):])
    pred = r["peak_gib_card"] * 2**30 / 1e9
    meas = base["max_memory_allocated_gb"]
    rel = (pred - meas) / meas
    print(f"dryrun (meta, phase 6's step: {TRAIN['arch']} f32, 1 PE, "
          f"{TRAIN['global_batch']} x seq in {TRAIN['microbatches']} "
          f"microbatches, remat): {r['t_run_s']} s in its own process "
          f"(done {time.monotonic() - t_start:.1f} s after its start); FLOPs "
          f"{r['flops_dev']:.4e} (matmul {r['matmul_flops']:.4e} + flash "
          f"kernel {r['kernel_flops']:.4e} over {r['flash_calls']} calls), "
          f"bytes {r['bytes_dev']:.4e}; H100 data-sheet terms compute "
          f"{r['compute_ms']:.1f} ms, memory {r['memory_ms']:.1f} ms; "
          f"measured step {base['seconds']:.2f} s; predicted peak "
          f"{pred:.2f} GB vs measured {meas:.2f} GB ({100 * rel:+.1f}%)",
          flush=True)
    if abs(rel) > DRYRUN_PEAK_TOL:
        fail(f"dryrun: predicted peak {pred:.2f} GB is {100 * rel:+.1f}% off "
             f"phase 6's {meas:.2f} GB (bound {DRYRUN_PEAK_TOL:.0%})")
    if r["flash_calls"] != flash:
        fail(f"dryrun: {r['flash_calls']} flash calls, phase 6 launched "
             f"{flash}")
    return {"predicted_peak_gb": pred, "measured_peak_gb": meas,
            "rel": rel, "flops": r["flops_dev"], "bytes": r["bytes_dev"],
            "flash_calls": r["flash_calls"], "t_run_s": r["t_run_s"]}


# ----------------------------------------------------------------------
# phase 7: timing
# ----------------------------------------------------------------------
def time_ms(fn, dev, iters=20) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, each after an L2
    flush (a 256 MB write), by CUDA events around each call.  A ~1 ms
    device spin before the first event lets the host enqueue the whole
    call first, so host-side launch cost does not show as device time."""
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def timing_floor(dev) -> float:
    """``time_ms`` of a one-element add: what the harness itself costs a
    timed call (the launch and the events), which every small kernel's
    time includes."""
    one = torch.zeros(1, device=dev)
    floor = time_ms(lambda: one.add_(1), dev)
    print(f"timing floor: a one-element add takes {floor:.4f} ms by the "
          f"same measure", flush=True)
    return floor


def rates(ms: float, nbytes: int, flops: int, bound_ms: float) -> dict:
    """Achieved rates of a kernel time and its share of the bound."""
    return {"achieved_tflop_s": flops / (ms * 1e-3) / 1e12,
            "achieved_gb_s": nbytes / (ms * 1e-3) / 1e9,
            "bound_share": bound_ms / ms}


def rate_text(r: dict) -> str:
    return (f"{r['achieved_tflop_s']:.2f} TFLOP/s, {r['achieved_gb_s']:.1f} "
            f"GB/s, {100 * r['bound_share']:.1f}% of the bound")


def gathered(kp, vp, bt, s):
    """Contiguous (B, H_kv, s, D) K/V gathered through the block table."""
    bl, hkv = bt.long(), kp.shape[-2]
    kc = kp[bl].reshape(B, -1, hkv, D)[:, :s].transpose(1, 2).contiguous()
    vc = vp[bl].reshape(B, -1, hkv, D)[:, :s].transpose(1, 2).contiguous()
    return kc, vc


def timing(pa, dev, launches, launches_f32, launches_spec, launches_moe,
           launches_moe_f32, errs, launches_disagg,
           launches_disagg_f32) -> list:
    dt = torch.bfloat16
    rows = [dict(name="paged_decode_attention",
                 **decode_timing_case(pa, dev, dt),
                 replaces="src/repro/kernels/paged_attention.py:216 "
                 "(paged_decode_attention, body _paged_kernel :126)")]
    rows.append(dict(name="paged_prefill_attention",
                     **prefill_timing_case(pa, dev, dt),
                     replaces="src/repro/kernels/paged_attention.py:358 "
                     "(paged_prefill_attention, body _prefill_kernel :227)"))

    out = []
    for r in rows:
        ms = time_ms(r["fn"], dev)
        plain_ms = time_ms(r["plain"], dev)
        lib_ms = time_ms(r["lib"], dev)
        bound_ms, by = bound_of(r["nbytes"], r["flops"], dt)
        err = max(errs[(r["name"], "bf16")], errs[(r["name"], "f32")])
        got = rates(ms, r["nbytes"], r["flops"], bound_ms)
        out.append({
            "name": r["name"], "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": r["replaces"], "launches": launches[r["name"]],
            "launches_bf16": launches[r["name"]],
            "launches_f32": launches_f32[(r["name"], "f32")],
            "max_abs_err": err, "max_err": err,
            "max_err_bf16": errs[(r["name"], "bf16")],
            "max_err_f32": errs[(r["name"], "f32")],
            "tol": {"bf16": TOL[torch.bfloat16], "f32": TOL[torch.float32]},
            "tol_decode_f32": DECODE_TOL[torch.float32],
            "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": lib_ms,
            "bound_bytes": r["nbytes"], "bound_flops": r["flops"], **got,
        })
        print(f"timing {r['name']} (bf16): kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({by}); {rate_text(got)}", flush=True)
    for dt in (torch.bfloat16, torch.float32):
        out[0].update(decode_long_timing(pa, dev, dt))
    # the f32 bodies beside the bf16 ones, same shapes
    for i, (name, case) in enumerate((
            ("paged_decode_attention", decode_timing_case),
            ("paged_prefill_attention", prefill_timing_case))):
        f = case(pa, dev, torch.float32)
        ms, plain_ms, lib_ms = (time_ms(f[k], dev)
                                for k in ("fn", "plain", "lib"))
        bound_ms, by = bound_of(f["nbytes"], f["flops"], torch.float32)
        got = rates(ms, f["nbytes"], f["flops"], bound_ms)
        out[i].update({"ms_f32": ms, "plain_ms_f32": plain_ms,
                       "library_ms_f32": lib_ms, "bound_ms_f32": bound_ms,
                       "bound_by_f32": by, "bound_bytes_f32": f["nbytes"],
                       **{f"{k}_f32": v for k, v in got.items()}})
        print(f"timing {name} (f32): kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({by}); {rate_text(got)}", flush=True)
    # the verify window (k+1 rows) through the prefill bodies, and the
    # speculative runs' launches of each paged kernel
    for dt in (torch.bfloat16, torch.float32):
        tag = "bf16" if dt == torch.bfloat16 else "f32"
        f = prefill_timing_case(pa, dev, dt, verify=True)
        ms, plain_ms, lib_ms = (time_ms(f[k], dev)
                                for k in ("fn", "plain", "lib"))
        bound_ms, by = bound_of(f["nbytes"], f["flops"], dt)
        got = rates(ms, f["nbytes"], f["flops"], bound_ms)
        out[1].update({f"verify_{tag}": {
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": by, **got}})
        print(f"timing paged_prefill_attention verify window ({tag}, "
              f"{B} x {SPEC_K + 1} rows): kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({by}); {rate_text(got)}", flush=True)
    for row in out:
        row["launches_spec"] = {f"{name}/{tag}": n for (name, tag), n
                                in launches_spec.items()
                                if name == row["name"]}
        row["launches_moe"] = launches_moe[(row["name"], "bf16")]
        row["launches_moe_f32"] = launches_moe_f32[(row["name"], "f32")]
        row["launches_disagg"] = launches_disagg[(row["name"], "bf16")]
        row["launches_disagg_f32"] = launches_disagg_f32[
            (row["name"], "f32")]
    moe_timing(pa, dev, out)
    return out


def moe_timing(pa, dev, out) -> None:
    """Decode and prefill at the MoE archs' layouts, each in its serving
    dtype, beside the plain versions, SDPA and the bound: into rows
    ``out[0]`` (decode) and ``out[1]`` (prefill) as ``moe_bf16`` /
    ``moe_f32``."""
    for arch, (heads, dt) in MOE_HEADS.items():
        tag = "bf16" if dt == torch.bfloat16 else "f32"
        for i, (name, case) in enumerate((
                ("paged_decode_attention", decode_timing_case),
                ("paged_prefill_attention", prefill_timing_case))):
            f = case(pa, dev, dt, heads=heads)
            ms, plain_ms, lib_ms = (time_ms(f[k], dev)
                                    for k in ("fn", "plain", "lib"))
            bound_ms, by = bound_of(f["nbytes"], f["flops"], dt)
            got = rates(ms, f["nbytes"], f["flops"], bound_ms)
            out[i][f"moe_{tag}"] = {
                "arch": arch, "heads": list(heads), "ms": ms,
                "plain_ms": plain_ms, "library_ms": lib_ms,
                "bound_ms": bound_ms, "bound_by": by,
                "bound_bytes": f["nbytes"], **got}
            print(f"timing {name} at {arch}'s layout ({tag}, H {heads[0]}, "
                  f"H_kv {heads[1]}): kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({by}); {rate_text(got)}", flush=True)


def decode_long_timing(pa, dev, dt) -> dict:
    """Decode in ``dt`` at the long-context shape (B sequences of
    LONG_LEN tokens): kernel, plain version, SDPA on the gathered K/V
    (every token valid, so no mask) and the byte bound; the f32 row's
    keys end in ``_f32``."""
    import torch.nn.functional as F

    tag = "f32" if dt == torch.float32 else "bf16"
    q, kp, vp, bt, lens = decode_long_case(dt, dev)
    kc, vc = gathered(kp, vp, bt, LONG_LEN)
    qs = q[:, :, None]
    isz = q.element_size()
    nbytes = (2 * q.numel() * isz + B * LONG_LEN * HKV * D * isz * 2
              + bt.numel() * 4 + lens.numel() * 4)
    flops = 4 * B * LONG_LEN * H * D
    ms = time_ms(lambda: pa.paged_decode_attention(q, kp, vp, bt, lens), dev)
    plain_ms = time_ms(lambda: pa.paged_decode_attention_ref(q, kp, vp, bt,
                                                             lens), dev)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qs, kc, vc, enable_gqa=True), dev)
    bound_ms, by = bound_of(nbytes, flops, dt)
    got = rates(ms, nbytes, flops, bound_ms)
    print(f"timing paged_decode_attention ({tag}, B={B} x {LONG_LEN} "
          f"tokens): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
          f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}); "
          f"{rate_text(got)}", flush=True)
    del q, kp, vp, kc, vc
    torch.cuda.empty_cache()
    sfx = "_f32" if dt == torch.float32 else ""
    row = {"long_ms": ms, "long_plain_ms": plain_ms,
           "long_library_ms": lib_ms, "long_bound_ms": bound_ms,
           "long_bound_by": by, "long_bound_bytes": nbytes,
           **{f"long_{k}": v for k, v in got.items()}}
    out = {k + sfx: v for k, v in row.items()}
    if not sfx:
        out["long_shape"] = {"b": B, "h": H, "hkv": HKV, "d": D, "p": P,
                             "length": LONG_LEN}
    return out


def bound_of(nbytes: int, flops: int, dtype) -> tuple:
    """(bound ms, "bytes" | "operations"): the larger of bytes over the
    memory rate and operations over the dtype's peak (the H100 SXM
    data-sheet rates of ``launch.roofline``)."""
    from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS
    t_bytes, t_ops = nbytes / HBM_BW, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations")


def decode_timing_case(pa, dev, dt, heads=(H, HKV)) -> dict:
    """Decode at the parity shape in ``dt`` with ``heads`` (query, KV):
    the kernel, its plain version and SDPA on pre-gathered K/V with the
    lengths' mask, and the bytes and flops of its bound (each valid K/V
    token read once per KV head, q read and out written once)."""
    import torch.nn.functional as F

    isz = torch.tensor([], dtype=dt).element_size()
    (h, hkv) = heads
    q, kp, vp, bt, lens = decode_case(dt, dev, heads=heads)
    s = max(DECODE_LENS)
    kc, vc = gathered(kp, vp, bt, s)
    mask = (torch.arange(s, device=dev)[None] < lens[:, None])[:, None, None]
    qs = q[:, :, None]
    ntok = sum(DECODE_LENS)
    return dict(
        fn=lambda: pa.paged_decode_attention(q, kp, vp, bt, lens),
        plain=lambda: pa.paged_decode_attention_ref(q, kp, vp, bt, lens),
        lib=lambda: F.scaled_dot_product_attention(qs, kc, vc, attn_mask=mask,
                                                   enable_gqa=True),
        nbytes=(2 * q.numel() * isz + ntok * hkv * D * isz * 2
                + bt.numel() * 4 + lens.numel() * 4),
        flops=4 * ntok * h * D)


def prefill_timing_case(pa, dev, dt, verify: bool = False,
                        heads=(H, HKV)) -> dict:
    """The prefill window at the parity shape in ``dt`` with ``heads``
    (or, with ``verify``, the k+1-row verify window): the kernel, its
    plain version and SDPA on pre-gathered K/V with the window's mask,
    and the bytes and flops of its bound (each K/V token a row sees read
    once, q read and out written once)."""
    import torch.nn.functional as F

    isz = torch.tensor([], dtype=dt).element_size()
    (h, hkv) = heads
    if verify:
        window, starts, ntoks = SPEC_K + 1, VERIFY_START, VERIFY_NTOK
        q2, kp2, vp2, bt2, start, n_tok = verify_case(dt, dev)
    else:
        window, starts, ntoks = WINDOW, WIN_START, WIN_NTOK
        q2, kp2, vp2, bt2, start, n_tok = prefill_case(dt, dev, heads=heads)
    s2 = max(a + n for a, n in zip(starts, ntoks))
    kc2, vc2 = gathered(kp2, vp2, bt2, s2)
    j = torch.arange(window, device=dev)[None]
    lim = torch.where(j < n_tok[:, None], start[:, None] + j + 1,
                      torch.zeros_like(j))
    mask2 = (torch.arange(s2, device=dev)[None, None] < lim[:, :, None])
    mask2 = mask2[:, None]
    qt = q2.transpose(1, 2)
    seen = sum(a + n for a, n in zip(starts, ntoks) if n)
    return dict(
        fn=lambda: pa.paged_prefill_attention(q2, kp2, vp2, bt2, start,
                                              n_tok),
        plain=lambda: pa.paged_prefill_attention_ref(q2, kp2, vp2, bt2,
                                                     start, n_tok),
        lib=lambda: F.scaled_dot_product_attention(qt, kc2, vc2,
                                                   attn_mask=mask2,
                                                   enable_gqa=True),
        nbytes=(2 * q2.numel() * isz + seen * hkv * D * isz * 2
                + bt2.numel() * 4 + 2 * B * 4),
        flops=sum(4 * (a + jj + 1) * h * D
                  for a, n in zip(starts, ntoks) for jj in range(n)))


def comm_timing(sc, rc, dev, launches, by_payload, errs) -> list:
    """The copy engine and the combine kernel at the ring chunk of a 64
    MiB-per-PE psum (8 PEs x 8 MiB of f32): kernel, plain version,
    library call (``x.clone()`` / ``torch.add``) and bound; then the copy
    and ``clone`` at the smaller staged payloads, and at every payload
    the comm phase staged, priced by its launches there."""
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(STAGED, generator=g, device=dev)
    y = torch.randn(STAGED, generator=g, device=dev)
    nbytes = x.numel() * x.element_size()
    # the variant the pallas stager picks for this payload (one PE's)
    variant = sc.choose_variant(x[0].numel() * x.element_size(), x.dtype)
    rows = [dict(name="copy_blocked", source="symm_copy.cu", variant=variant,
                 fn=lambda: sc.copy_blocked(x, variant),
                 plain=lambda: sc.copy_blocked_ref(x, variant),
                 lib=lambda: x.clone(), nbytes=2 * nbytes, flops=0,
                 replaces="src/repro/kernels/symm_copy.py:101 (copy_blocked, "
                 "pl.pallas_call :126, body _copy_kernel :97)"),
            dict(name="combine_blocked", source="reduce_combine.cu",
                 variant=rc.DEFAULT_VARIANT,
                 fn=lambda: rc.combine_blocked(x, y, "sum"),
                 plain=lambda: rc.combine_blocked_ref(x, y, "sum"),
                 lib=lambda: torch.add(x, y), nbytes=3 * nbytes,
                 flops=x.numel(),
                 replaces="src/repro/kernels/reduce_combine.py:37 "
                 "(combine_blocked, pl.pallas_call :57, body "
                 "_combine_kernel :33)")]
    out = []
    for r in rows:
        ms = time_ms(r["fn"], dev)
        plain_ms = time_ms(r["plain"], dev)
        lib_ms = time_ms(r["lib"], dev)
        bound_ms, by = bound_of(r["nbytes"], r["flops"], torch.float32)
        got = rates(ms, r["nbytes"], r["flops"], bound_ms)
        out.append({
            "name": r["name"], "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{r['source']}",
            "replaces": r["replaces"], "launches": launches[r["name"]],
            "max_abs_err": errs[r["name"]], "tol": 0.0,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "library_ms": lib_ms,
            "bound_bytes": r["nbytes"], "bound_flops": r["flops"],
            "shape": list(STAGED), "dtype": "float32",
            "variant": r["variant"], **got,
        })
        print(f"timing {r['name']} (f32 {STAGED}, variant {r['variant']}): "
              f"kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({by}); {rate_text(got)}", flush=True)
    del x, y
    out[0]["smaller_payloads"] = [copy_row(sc, dev, shape)
                                  for shape in STAGED_SMALL]
    out[0].update(copy_path_cost(sc, dev, by_payload))
    return out


def copy_row(sc, dev, shape) -> dict:
    """The copy kernel and ``clone`` (timed in turns) at one staged f32
    payload, with the variant the stager picks for it."""
    x = torch.randn(shape, device=dev)
    nbytes = x.numel() * x.element_size()
    variant = sc.choose_variant(x[0].numel() * x.element_size(), x.dtype)
    ms = time_ms(lambda: sc.copy_blocked(x, variant), dev)
    clone_ms = time_ms(lambda: x.clone(), dev)
    bound_ms, _ = bound_of(2 * nbytes, 0, torch.float32)
    print(f"timing copy_blocked (f32 {tuple(shape)}, copy variant "
          f"{variant}): kernel {ms:.4f} ms, clone {clone_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms", flush=True)
    return {"shape": list(shape), "copy_variant": variant, "ms": ms,
            "library_ms": clone_ms, "bound_ms": bound_ms}


def copy_path_cost(sc, dev, by_payload) -> dict:
    """Sum over the payloads the comm phase staged of launches x time, for
    the copy kernel and for ``clone`` at the same payloads; each payload's
    two times are printed and kept."""
    kernel = clone = 0.0
    rows = []
    for (nbytes, dtype, variant), n in sorted(by_payload.items()):
        x = torch.empty(nbytes // torch.empty((), dtype=getattr(
            torch, dtype)).element_size(), dtype=getattr(torch, dtype),
            device=dev)
        ms = time_ms(lambda: sc.copy_blocked(x, variant), dev, 5)
        clone_ms = time_ms(lambda: x.clone(), dev, 5)
        kernel += n * ms
        clone += n * clone_ms
        rows.append({"bytes": nbytes, "dtype": dtype, "copy_variant": variant,
                     "launches": n, "ms": ms, "library_ms": clone_ms})
        print(f"timing copy_blocked at a staged payload of {nbytes} B "
              f"({dtype}, {variant}, {n} launches): kernel {ms:.4f} ms, "
              f"clone {clone_ms:.4f} ms", flush=True)
        del x
    print(f"timing copy_blocked on the comm path: {len(by_payload)} staged "
          f"payloads, sum of launches x time: kernel {kernel:.3f} ms, clone "
          f"{clone:.3f} ms at the same payloads", flush=True)
    return {"path_payloads": rows, "path_ms": kernel,
            "path_library_ms": clone}


def flash_timing(fa, dev, launches, errs) -> dict:
    """The flash kernel at the training shape: kernel, plain version,
    SDPA (causal, GQA) and bound, in f32 (the trainer's dtype, the row's
    main numbers) and bf16."""
    import torch.nn.functional as F

    f = FLASH_FULL
    b, h, t, d = f["b"], f["h"], f["t"], f["d"]
    flops = 4 * b * h * d * t * (t + 1) // 2           # causal: QK^T and PV
    row = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention.py:89 "
           "(flash_attention, pl.pallas_call :132, body _flash_kernel :29)",
           "launches": launches, "max_abs_err": max(errs.values()),
           "max_err_f32": errs["f32"], "max_err_bf16": errs["bf16"],
           "tol": {"bf16": TOL[torch.bfloat16], "f32": TOL[torch.float32]},
           "shape": f, "bound_flops": flops}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        q, k, v = flash_inputs(f, dtype, dev)
        qc = q.contiguous()
        isz = q.element_size()
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * isz + b * h * t * 4
        ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=True), dev)
        plain_ms = time_ms(lambda: fa.flash_attention_ref(q, k, v,
                                                          causal=True), dev)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qc, k, v, is_causal=True, enable_gqa=True), dev)
        bound_ms, by = bound_of(nbytes, flops, dtype)
        got = rates(ms, nbytes, flops, bound_ms)
        vals = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                "bound_ms": bound_ms, "bound_by": by, "bound_bytes": nbytes,
                **got}
        if dtype == torch.float32:
            row.update(vals)
            row["kernel_ms"] = ms
        row.update({f"{k_}_{tag}": v_ for k_, v_ in vals.items()})
        print(f"timing flash_attention ({tag}, B={b} H={h} H_kv={f['hkv']} "
              f"T=S={t} D={d} causal): kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({by}; {flops:.3e} flops, {nbytes} bytes); "
              f"{rate_text(got)}", flush=True)
        del q, k, v, qc
    torch.cuda.empty_cache()
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--comm-out", default=None,
                    help="write the comm phase's bench JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: no repro_torch package under {SRC}",
              file=sys.stderr)
        return 3
    sys.path.insert(0, SRC)
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import reduce_combine as rc
    from repro_torch.kernels import symm_copy as sc

    # a reference states and sets its matmul precision: full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_all = time.monotonic()

    card = card_line()
    print(f"device: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}",
          flush=True)

    t0 = time.monotonic()
    sources = (pa.SOURCE, sc.SOURCE, rc.SOURCE, fa.SOURCE)
    with ThreadPoolExecutor(len(sources)) as ex:     # one nvcc per source
        list(ex.map(build.build, sources))
    print(f"build: {', '.join(sources)} in {time.monotonic() - t0:.1f} s",
          flush=True)
    for src in sources:
        if src not in build.BUILD_LOG:
            print(f"{src}: library already built", flush=True)
    print_resources(fa, pa, sc, rc)
    mark = [time.monotonic()]

    def phase_done(name):
        now = time.monotonic()
        print(f"phase {name}: {now - mark[0]:.1f} s", flush=True)
        mark[0] = now

    errs = parity(pa, dev)
    flash_errs = flash_parity(fa, dev)
    flash_autograd_parity(fa, dev)
    comm_errs = comm_kernel_parity(sc, rc, dev)
    phase_done("3 parity")
    launches, launches_spec, launches_disagg, colo, colo_peak = \
        serve_full(pa, dev)
    launches_f32, launches_disagg_f32 = serve_full_f32(pa, dev)
    launches_moe, moe1 = serve_moe_bf16(pa, dev)
    launches_moe_f32, moe1_f32 = serve_moe_f32(pa, dev)
    for arch in ("qwen3-8b", MOE_BF16, MOE_F32):
        serve_smoke_streams(pa, dev, arch)
    phase_done("4 serve")
    comm_launches, comm_payloads = comm_phase(sc, rc, dev, args.comm_out)
    phase_done("5 comm")
    dry = dryrun_start()
    flash_launches, train_base = train_full(fa, dev)
    train_smoke_parity(dev)
    phase_done("6 train")
    timing_floor(dev)
    kernels = timing(pa, dev, launches, launches_f32, launches_spec,
                     launches_moe, launches_moe_f32, errs,
                     launches_disagg, launches_disagg_f32) + \
        comm_timing(sc, rc, dev, comm_launches, comm_payloads, comm_errs) + \
        [flash_timing(fa, dev, flash_launches, flash_errs)]
    phase_done("7 timing")
    launches_swap = swap_stage(pa, dev, colo)
    phase_done("8 hot-swap")
    launches_ckpt = ckpt_stage(fa, dev)
    phase_done("9 ckpt")
    launches_tp, copies_tp, errs_tp = tp_stage(pa, sc, dev, colo, colo_peak)
    phase_done("10 tp")
    launches_mtp, copies_mtp, errs_mtp, layouts_mtp = moe_tp_stage(
        pa, sc, dev, moe1, moe1_f32)
    phase_done("11 moe tp")
    flash_dp, copies_dp = dp_stage(fa, sc, dev, train_base)
    phase_done("12 dp")
    launches_a10, errs_a10, rows_a10 = a10_stage(fa, dev)
    phase_done("13 a10")
    launches_xattn, errs_xattn, rows_xattn = xattn_stage(fa, dev)
    phase_done("14 xattn")
    launches_tmoe, launches_ttp, errs_t15 = t15_stage(fa, dev)
    phase_done("15 tp train")
    launches_t16, copies_t16, rows_t16 = t16_stage(fa, sc, dev)
    phase_done("16 tp families")
    copies_pm = posh_micro_stage(sc, dev, card)
    checker = checker_stage(dev)
    dry = dryrun_stage(*dry, train_base, flash_launches)
    phase_done("17 posh-micro, checker, dry run")
    for row in kernels:
        if row["name"].startswith("paged_"):
            row["launches_swap"] = launches_swap[(row["name"], "bf16")]
            for key, launches, errs in (("tp", launches_tp, errs_tp),
                                        ("moe_tp", launches_mtp, errs_mtp)):
                by = {tag: n for (name, tag), n in launches.items()
                      if name == row["name"]}
                row[f"launches_{key}"] = sum(by.values())
                row[f"launches_{key}_by_dtype"] = by
                row[f"max_abs_err_{key}"] = errs[row["name"]]
            row["moe_tp_layouts"] = {arch: t[row["name"]]
                                     for arch, t in layouts_mtp.items()}
        elif row["name"] == "flash_attention":
            row["launches_ckpt"] = launches_ckpt
            row["launches_dp"] = flash_dp
            row["launches_a10"] = launches_a10
            row["max_abs_err_a10"] = errs_a10
            row["a10_shapes"] = rows_a10
            row["launches_xattn"] = launches_xattn
            row["max_abs_err_xattn"] = errs_xattn
            row["xattn_shapes"] = rows_xattn
            row["launches_train_moe"] = launches_tmoe
            row["launches_train_tp"] = launches_ttp
            row["max_abs_err_train"] = errs_t15
            row["launches_tp_families"] = launches_t16
            row["max_abs_err_tp_families"] = max(
                r["max_abs_err"] for r in rows_t16.values())
            row["tp_families_shapes"] = rows_t16
            row["dryrun_phase6"] = dry
        elif row["name"] == "copy_blocked":
            row["launches_tp"] = copies_tp
            row["launches_moe_tp"] = copies_mtp
            row["launches_dp"] = copies_dp
            row["launches_tp_families"] = copies_t16
            row["launches_posh_micro"] = copies_pm
            row["checker"] = checker

    print(f"total: {time.monotonic() - t_all:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
