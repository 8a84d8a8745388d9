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
               the first's stream; and an SLO run (``--slo 0.5+0.25``,
               TTFT deadlines, a pool that forces eviction, a shed) whose
               served streams must equal an FCFS run's and whose
               interactive attainment must beat FCFS's; then, that
               engine freed,
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
               prefill body, replay and draft accepting everything;
               then, that engine freed, the MoE stage: qwen3-moe-30b-a3b
               at full width in bf16 (48 layers, 128 experts top-8,
               30.5 B parameters drawn on the card from seed 0) serves
               the seeded 8-request trace twice (clock "tick", the same
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
               op: us/call and GB/s; then 10 psums per backend at 64 KiB
               and 64 MiB per PE under the profiler (device busy share,
               kernels by kind).
               ``--comm-out FILE`` writes the bench dict there;
  6. train   — ``repro_torch.launch.train.build_trainer`` on full-width
               gemma-2b (18 layers, f32 parameters and compute, AdamW,
               weights drawn on the card from a seed), sequences of
               4096 tokens, global batch 8 in 8 microbatches, 3 steps:
               per-step loss, seconds, tokens/s and peak memory; the
               flash launch counter, zeroed just before, must equal the
               count predicted in PERF.md (18 layers x 8 microbatches x
               3 steps x 2, the recompute under remat included); then
               one more step under the profiler; then gemma-2b-smoke and
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
               its share of the bound (bound ms / kernel ms).

Phase 3 also holds the flash-attention kernel against its plain version
in f32 (1e-4) and bf16 (2e-2), on the output and the log-sum-exp, at the
training path's full width (B=1, H=8, H_kv=1, T=S=4096, D=256, causal),
at D=128 with a group of 4, at a sliding window of 96 over a ragged
T=S=1000 and without the causal mask; and the autograd path (kernel
forward, plain backward) against the all-plain path on the grads.

``launches`` in the kernels line is each kernel's count from its main
path (the bf16 serve run for the paged-attention kernels, with
``launches_f32`` from the f32 serve run, ``launches_spec`` summed
over the speculative runs, ``launches_moe`` from the bf16
qwen3-moe-30b-a3b run and ``launches_moe_f32`` from the f32
qwen2-moe-a2.7b run), the communicator calls for
the copy engine, the gemma-2b training steps for the flash kernel; 0
for ``combine_blocked``, which is reached only through ``ops.combine``).
It prints a ``{"kernels": [...]}`` line, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without the repository's ``src/`` beside it, it exits
non-zero and prints no result.  It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time
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
HBM_BYTES_S = 3.35e12                              # H100 SXM data sheet
# the comm path: 8 PEs; the ring chunk of a 64 MiB-per-PE psum, 8 x 8 MiB
# of f32 (the path also stages larger payloads, to 8 x 64 MiB, each timed
# in the path's sum); and two smaller staged payloads of the path, 8 x 64
# KiB and 8 x 1 MiB
N_PE = 8
STAGED = (N_PE, 2 << 20)
STAGED_SMALL = [(N_PE, 16 << 10), (N_PE, 256 << 10)]
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

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
TRAIN = dict(arch="gemma-2b", global_batch=8, microbatches=8, steps=3)

SERVE_TRACE = dict(n_requests=8, rate=8.0, seed=0,
                   prompt_short=(64, 257), prompt_long=(257, 513),
                   long_frac=0.25, out_short=(32, 65), out_long=(32, 65))
# the f32 serve run (the reference's serving dtype): the same 8 requests
# with their outputs cut to 16-32 tokens, so the phase stays near 30 s
SERVE_TRACE_F32 = {**SERVE_TRACE, "out_short": (16, 33), "out_long": (16, 33)}
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
# the MoE stage: qwen3-moe-30b-a3b at full width in bf16 (61.1 GB of
# weights, 512 pages of 1.57 MB) and qwen2-moe-a2.7b in f32, the
# reference's serving dtype (60.6 GB of weights; 256 pages of 6.3 MB,
# 1.6 GB: 512 would take ~64 GB with the weights and leave too little
# of the 80 for the plain path's comparison and the step's activations)
MOE_BF16, MOE_F32 = "qwen3-moe-30b-a3b", "qwen2-moe-a2.7b"
MOE_F32_PAGES = 256
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
    eng.run(make_requests(TrafficConfig(
        vocab=cfg.vocab, **{**SERVE_TRACE, "n_requests": 2, "seed": 99})))
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
    del eng
    torch.cuda.empty_cache()
    return launches, launches_spec


def serve_full_f32(pa, dev) -> dict:
    """Full-width qwen3-8b served in f32, the reference's serving dtype:
    first-step logits of the kernel path against the plain path, then a
    seeded trace whose f32 paged-attention launches, zeroed just before,
    must equal n_layers x the run's steps (and no bf16 body may run).
    Returns the run's launches by (kernel, dtype)."""
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
    del eng
    torch.cuda.empty_cache()
    return launches


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


def decode_margins(eng, cfg, cases) -> list:
    """The non-speculative path's logits for output ``j`` of each of
    ``cases`` ((prompt, outputs, j), at most max_batch of them), one case
    a row of the serve run's shapes: the prompts through 64-token prefill
    windows, outputs 0..j-1 through decode steps, on a fresh pool; a row
    that has nothing to feed in a step sits idle on page 0, as the
    engine's idle rows do.  Returns (top-1 minus top-2 logit, top-1
    token) per case."""
    from repro_torch.models import embed as emb
    from repro_torch.serve import engine as se

    scfg, params, dev = eng.scfg, eng.exec.params, eng.device
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
    window = se._make_window_forward(cfg, scfg)
    decode = se._make_decode_forward(cfg, scfg)
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
                logits[i] = emb.lm_head_logits(head, x[i, int(n_tok[i]) - 1])
    for t in range(max(j for _, _, j in cases)):
        tok, pos, lens, active = z(), z(), z(), []
        for i, (prompt, outs, j) in enumerate(cases):
            if t < j:
                n = len(prompt) + t
                tok[i], pos[i], lens[i] = outs[t], n, n + 1
                active.append(i)
        x, pool = decode(params, pool, tok.to(dev), pos.to(dev),
                         rows(active), lens.to(dev))
        for i in active:
            if t == cases[i][2] - 1:
                logits[i] = emb.lm_head_logits(head, x[i])
    del pool
    out = []
    for lg in logits:
        top = lg.float().topk(2)
        out.append(((top.values[0] - top.values[1]).item(),
                    int(top.indices[0])))
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


def margin_text(eng, cfg, reqs, spec: dict, plain: dict) -> tuple:
    """Every stream where ``spec`` leaves ``plain`` (the non-spec run's
    streams of ``reqs``): (number of equal streams, text with each first
    divergence and the non-spec run's top-2 logit margin there)."""
    div = divergences(spec, plain)
    prompts = {r.rid: r.prompt for r in reqs}
    margins = decode_margins(eng, cfg, [(prompts[rid], plain[rid], j)
                                        for rid, j in div]) if div else []
    text = "; ".join(
        f"request {rid} output {j}: spec {spec[rid][j:j + 3]} vs non-spec "
        f"{plain[rid][j:j + 3]}, non-spec top-2 margin {mg:.6g} (top-1 "
        f"{top})" for (rid, j), (mg, top) in zip(div, margins))
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


def first_step_logits(eng, cfg, reqs) -> None:
    """The first prefill chunk (64 tokens of each of the trace's first 8
    prompts) and the first decode step after it, through the engine's
    own trunks on its weights, once with the kernels and once with the
    plain versions, each on a fresh pool: the logits must agree within
    LOGIT_TOL x max |logit|.  (Full-width streams are not compared: a
    greedy near-tie in f32 may flip with the summation order.)"""
    import dataclasses

    from repro_torch.models import embed as emb
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


def _profiled(run, top: int = 6) -> dict:
    """Run ``run()`` under the profiler: device time by kernel and by
    kind, and the device's busy share of the wall time (a lower bound:
    the profiler adds host time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
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
def moe_engine(arch, dtype, dev, n_pages):
    """``build_engine`` on ``arch``: weights drawn on ``dev`` from seed 0;
    prints the parameter count and the bytes the weights take."""
    import gc

    from repro_torch.launch.serve import build_engine
    from repro_torch.train.tree import leaves

    gc.collect()                 # earlier engines' cycles, then their memory
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    t0 = time.monotonic()
    eng, cfg = build_engine(arch, config="full", dtype=dtype, device=dev,
                            page_tokens=P, n_pages=n_pages, max_batch=B,
                            prefill_chunk=WINDOW, attn_impl="kernel", seed=0)
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in leaves(eng.exec.params))
    w_bytes = sum(t.numel() * t.element_size()
                  for t in leaves(eng.exec.params))
    m = cfg.moe
    print(f"serve moe: {cfg.name}, {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv}, head_dim "
          f"{cfg.head_dim}, {m.num_experts} experts (padded "
          f"{m.experts_padded(1)}) top-{m.top_k} of ff {m.expert_ff}, "
          f"shared ff {m.shared_ff}, capacity factor {m.capacity_factor}; "
          f"{n_par / 1e9:.3f} B parameters, {dtype} weights "
          f"{w_bytes / 1e9:.2f} GB, pool {n_pages} pages "
          f"{eng.pool.numel() * eng.pool.element_size() / 1e9:.3f} GB, on "
          f"the card {torch.cuda.memory_allocated(dev) / 1e9:.2f} GB (held "
          f"before {held / 1e9:.2f}), init {time.monotonic() - t0:.1f} s",
          flush=True)
    return eng, cfg


def moe_serve_run(pa, eng, cfg, trace, tag) -> tuple:
    """One run of the seeded ``trace`` on ``eng`` (clock "tick": arrivals
    by tick, so a second run has the same batches and, under the
    capacity's drops, the same streams); the paged-attention launches,
    zeroed just before, must equal n_layers x the run's prefill and
    decode steps.  Returns (streams, launches by (kernel, dtype),
    metrics with wall seconds, tok/s and peak memory)."""
    from repro_torch.serve import TrafficConfig, make_requests

    reqs = make_requests(TrafficConfig(vocab=cfg.vocab, **trace))
    eng.reset_metrics()
    torch.cuda.reset_peak_memory_stats(eng.device)
    pa.reset_launches()
    torch.cuda.synchronize()
    t0 = time.monotonic()
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
    return streams_of(done), launches, out


def moe_decode_profile(eng, cfg, trace) -> dict:
    """Ten profiled decode-only ticks of ``trace`` (submitted at once,
    prefilled first), and the decode step's device time beside its
    weight-read bound: every weight but the embedding table is read once
    a step (the expert products run over every expert, empty or not, and
    the head reads its whole table), at 3.35 TB/s."""
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
    bound_ms = step_bytes / HBM_BYTES_S * 1e3
    out = {"decode_only_ticks": win, "decode_step_device_ms": step_ms,
           "weight_bytes_per_step": step_bytes,
           "weight_read_bound_ms": bound_ms,
           "bound_share": bound_ms / step_ms,
           "decode_step_wall_ms": win["wall_ms"] / n}
    print(f"profile {cfg.name}: " + json.dumps(out), flush=True)
    return out


def moe_routing_compare(eng, cfg, reqs, gated: bool) -> dict:
    """The first prefill chunk (64 tokens of each of the trace's first 8
    prompts) and the first decode step after it, through the engine's own
    trunks on its weights, once with the kernels and once with the plain
    versions, each on a fresh pool, the port's ``route`` and
    ``positions_in_expert`` wrapped here to record every layer's top-k
    set, keep mask and gate gap.  A flip is a row whose top-k set or
    kept set differs between the two; it reaches later layers of its
    row, later rows of its sequence (attention) and, in the decode step,
    its sequence.  Rows no flip reaches must give logits within
    LOGIT_TOL x max |logit| of the plain path's, and every flip no
    earlier flip reached must change the top-k set at a near-tie (the
    relative gap below MOE_TIE), and every keep-only flip no earlier flip
    reached must follow a set change at an earlier row of its layer (the
    capacity cascade); with ``gated`` False (bf16) this is printed, not
    checked."""
    import dataclasses

    from repro_torch.models import embed as emb
    from repro_torch.models import mlp
    from repro_torch.serve import engine as se

    scfg, params, dev = eng.scfg, eng.exec.params, eng.device
    m, tie = cfg.moe, MOE_TIE[scfg.dtype]
    n_exp, k = m.experts_padded(1), m.top_k
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

    route0, slots0 = mlp.route, mlp.positions_in_expert
    rec: list = []

    def route(router_w, xt, cfg_):
        gate_k, idx_k = route0(router_w, xt, cfg_)
        logits = (xt @ router_w.to(xt.dtype)).float()
        logits[:, m.num_experts:] = -1e30
        top = torch.softmax(logits, -1).topk(k + 1, dim=-1).values
        member = torch.zeros((xt.shape[0], n_exp), dtype=torch.bool,
                             device=xt.device)
        rec.append({"member": member.scatter_(1, idx_k, True), "idx": idx_k,
                    "gap": (top[:, k - 1] - top[:, k]) / top[:, k - 1]})
        return gate_k, idx_k

    def slots(idx_k, n_experts):
        pos = slots0(idx_k, n_experts)
        n = idx_k.shape[0]
        cap = int(n * k * m.capacity_factor / n_experts) + 1
        kept = torch.zeros((n, n_experts), dtype=torch.bool,
                           device=idx_k.device)
        rec[-1]["kept"] = kept.scatter_(1, idx_k, (pos < cap).view(n, k))
        return pos

    got = {}
    mlp.route, mlp.positions_in_expert = route, slots
    try:
        for impl in ("kernel", "ref"):
            sc2 = dataclasses.replace(scfg, attn_impl=impl)
            pool = eng.exec.init_pool()
            rec = []
            x, pool = se._make_window_forward(cfg, sc2)(params, pool, ids,
                                                        start, n_tok, bt)
            lp = emb.lm_head_logits(head, x[rows, n_tok.long() - 1]).float()
            win_rec = rec
            # both paths decode the token the kernel path's logits pick
            tok = (lp if impl == "kernel" else got["kernel"][0]).argmax(-1)
            rec = []
            x, pool = se._make_decode_forward(cfg, sc2)(
                params, pool, tok.to(torch.int32), n_tok, bt, n_tok + 1)
            got[impl] = (lp, emb.lm_head_logits(head, x).float(), win_rec,
                         rec)
            del pool, x
    finally:
        mlp.route, mlp.positions_in_expert = route0, slots0
    torch.cuda.synchronize()

    def walk(kr, rr, shape, tainted):
        """Flips layer by layer; returns (tainted rows after the last
        layer, flips [(layer, row, set changed, gap, reached before)])."""
        flips = []
        for li, (a, z) in enumerate(zip(kr, rr)):
            setf = (a["member"] != z["member"]).any(1).view(shape)
            fl = setf | (a["kept"] != z["kept"]).any(1).view(shape)
            rows_ = torch.nonzero(fl.flatten()).flatten().tolist()
            if rows_:
                sf, gp, tn = (t.flatten().cpu().tolist()
                              for t in (setf, a["gap"], tainted))
                flips += [(li, r, sf[r], gp[r], tn[r]) for r in rows_]
            tainted = tainted | fl
            if len(shape) == 2:       # attention: later rows of the sequence
                tainted = tainted.cumsum(1) > 0
        return tainted, flips

    out = {"tie": tie, "gated": gated}
    t_win, f_win = walk(got["kernel"][2], got["ref"][2], (b, c),
                        torch.zeros((b, c), dtype=torch.bool, device=dev))
    t_dec, f_dec = walk(got["kernel"][3], got["ref"][3], (b,),
                        t_win.any(1))
    held = {"prefill": ~t_win[rows, n_tok.long() - 1], "decode": ~t_dec}
    for i, (step, flips) in enumerate((("prefill", f_win),
                                       ("decode", f_dec))):
        kl, rl = got["kernel"][i], got["ref"][i]
        if not (torch.isfinite(kl).all() and kl.shape == (b, cfg.vocab)):
            fail(f"moe {cfg.name}: first {step} logits not finite of shape "
                 f"({b}, {cfg.vocab})")
        hold = held[step]
        scale = rl.abs().max().item()
        err = ((kl - rl).abs().max(1).values[hold].max().item()
               if hold.any() else float("nan"))
        # flips no earlier flip reached: a changed top-k set there can come
        # only from the two paths' rounding, so it must sit at a near-tie;
        # a changed keep mask alone is the capacity cascade of a set change
        # at an earlier row of the same layer
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
        print(f"moe {cfg.name} {step}: {len(flips)} flips (row = sequence"
              f"{f' x {c} + position' if step == 'prefill' else ''}); "
              f"{len(roots)} set flips no earlier flip reached (layer:row:"
              f"gap) " + " ".join(f"{f[0]}:{f[1]}:{f[3]:.2e}" for f in roots)
              + f"; {len(cascades)} keep-only cascades (layer:row) "
              + " ".join(f"{f[0]}:{f[1]}" for f in cascades)
              + f"; held rows {int(hold.sum())} of {b}, max |kernel - plain| "
              f"{err:.3e} (tol {LOGIT_TOL} x max |logit| {scale:.3f}); near-"
              f"tie bar {tie:.3e}{'' if gated else ' (printed, not gated)'}",
              flush=True)
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


def serve_moe_bf16(pa, dev) -> dict:
    """qwen3-moe-30b-a3b in bf16: the seeded trace served twice on the
    same engine (the same streams both times), launches = n_layers x
    steps; a profiled decode-only window against the weight-read bound;
    the routing comparison, printed.  Returns the counted run's launches
    by (kernel, dtype)."""
    from repro_torch.serve import TrafficConfig, make_requests

    t0 = time.monotonic()
    eng, cfg = moe_engine(MOE_BF16, "bf16", dev, 512)
    # warm-up on a throwaway trace (cuBLAS handles, first launches)
    eng.run(make_requests(TrafficConfig(
        vocab=cfg.vocab, **{**SERVE_TRACE, "n_requests": 2, "seed": 99})),
        clock="tick")
    first, launches, _ = moe_serve_run(pa, eng, cfg, SERVE_TRACE, "moe bf16")
    again, _, _ = moe_serve_run(pa, eng, cfg, SERVE_TRACE, "moe bf16 again")
    if again != first:
        bad = sorted(r for r in first if again.get(r) != first[r])
        fail(f"serve moe bf16: the second run's streams differ (requests "
             f"{bad})")
    print("serve moe bf16: the second run gave the same streams", flush=True)
    moe_decode_profile(eng, cfg, SERVE_TRACE)
    reqs = make_requests(TrafficConfig(vocab=cfg.vocab, **SERVE_TRACE))
    moe_routing_compare(eng, cfg, reqs, gated=False)
    del eng
    torch.cuda.empty_cache()
    print(f"serve moe bf16 stage: {time.monotonic() - t0:.1f} s", flush=True)
    return launches


def serve_moe_f32(pa, dev) -> dict:
    """qwen2-moe-a2.7b in f32, the reference's serving dtype: the routing
    comparison, gated; then the seeded f32 trace, launches = n_layers x
    steps.  Returns the run's launches by (kernel, dtype)."""
    from repro_torch.serve import TrafficConfig, make_requests

    t0 = time.monotonic()
    eng, cfg = moe_engine(MOE_F32, "f32", dev, MOE_F32_PAGES)
    reqs = make_requests(TrafficConfig(vocab=cfg.vocab, **SERVE_TRACE_F32))
    moe_routing_compare(eng, cfg, reqs, gated=True)
    _, launches, _ = moe_serve_run(pa, eng, cfg, SERVE_TRACE_F32, "moe f32")
    del eng
    torch.cuda.empty_cache()
    print(f"serve moe f32 stage: {time.monotonic() - t0:.1f} s", flush=True)
    return launches


# ----------------------------------------------------------------------
# phase 5: comm
# ----------------------------------------------------------------------
def comm_phase(sc, rc, dev, out_path=None) -> dict:
    """The comm path, 8 PEs on the card, through comm_bench (which checks
    every cell it times); returns the kernels' launch counts on the main
    path, the communicator calls."""
    from repro_torch.launch import comm_bench as cb

    t0 = time.monotonic()
    reps = 10
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
def train_full(fa, dev) -> int:
    """Full-width gemma-2b training steps through build_trainer; returns
    the flash launches of the measured steps."""
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
    prof = _profiled(lambda: tr.step(TRAIN["steps"]), top=8)
    print("train profile (one step): " + json.dumps(prof), flush=True)
    del tr
    torch.cuda.empty_cache()
    return launches


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
           launches_moe_f32, errs) -> list:
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
    memory rate and operations over the dtype's peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / PEAK_FLOPS[dtype]
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

    errs = parity(pa, dev)
    flash_errs = flash_parity(fa, dev)
    flash_autograd_parity(fa, dev)
    comm_errs = comm_kernel_parity(sc, rc, dev)
    launches, launches_spec = serve_full(pa, dev)
    launches_f32 = serve_full_f32(pa, dev)
    launches_moe = serve_moe_bf16(pa, dev)
    launches_moe_f32 = serve_moe_f32(pa, dev)
    for arch in ("qwen3-8b", MOE_BF16, MOE_F32):
        serve_smoke_streams(pa, dev, arch)
    comm_launches, comm_payloads = comm_phase(sc, rc, dev, args.comm_out)
    flash_launches = train_full(fa, dev)
    train_smoke_parity(dev)
    timing_floor(dev)
    kernels = timing(pa, dev, launches, launches_f32, launches_spec,
                     launches_moe, launches_moe_f32, errs) + \
        comm_timing(sc, rc, dev, comm_launches, comm_payloads, comm_errs) + \
        [flash_timing(fa, dev, flash_launches, flash_errs)]

    print(f"total: {time.monotonic() - t_all:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
