"""Serving CLI: continuous batching over the paged symmetric-heap KV
cache with seeded synthetic traffic, on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \\
        --requests 8 --page-tokens 16 --n-pages 512 --max-batch 8 \\
        --prefill-chunk 64

``--arch`` is a dense decoder (qwen3-8b, gemma-2b) or a MoE one
(qwen3-moe-30b-a3b: 128 experts, top-8; qwen2-moe-a2.7b: 60 experts
padded to 64, top-4, a shared expert), routed with the reference's
expert capacity.  ``--config full`` (the default) serves the published
config at full width in bf16 (``--dtype f32`` for the reference's
serving dtype) with random weights made on the card from ``--seed``;
``--config smoke`` the reduced CPU-test config.  The engine runs on the
card; ``--device cpu`` runs the plain CPU versions of the kernels.
``--spec-k N`` turns on speculative decoding (``--draft ngram``, the
prompt-lookup self-draft, or an arch name for a draft model drawn from
``--seed + 1``); ``--slo I+B`` mixes interactive / batch / best-effort
traffic under the SLO policy (``--ttft``, ``--tenants``,
``--tenant-rate``); ``--prefix-keep`` keeps finished prompts' full
pages as a migratable prefix cache.  ``--disagg P+D`` serves on P
prefill and D decode cells over one weights dict, each finished prefill
handing its pages to a decode cell by put-with-signal (speculation there
drafts with the n-gram proposer, as the reference's cells do: a
``--draft`` model is replaced by it, with a notice on stderr); ``--router
amo`` arbitrates admission, stealing and page grants by AMOs on
symmetric words (colocated: the page pool alone).  For a dense model
none of these changes a token: speculation, migration, cells and
routers only change how many ticks a stream takes.  A MoE model's
streams are the same only while no expert's capacity drops a token:
drops depend on which tokens share a step, in the reference as here.
``--hot-swap`` streams a second weight generation (drawn from ``--seed
+ 1000``) into the live engine during the run, with the reference's
defaults: 4 rows of 16 KiB a tick, so a full-width model takes about
250,000 ticks (``begin_hot_swap(chunk_rows=, row_bytes=)`` sizes it for
a real stream); its accounting lands in ``metrics()["swap"]``.
Prints per-request traces with ``--trace``, then the
throughput/latency summary (with its ``spec``, ``slo`` and ``swap``
blocks).
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from repro_torch import configs
from repro_torch.device import dtype_of, resolve
from repro_torch.models import lm, registry
from repro_torch.serve import (DisaggEngine, DraftModelProposer,
                               SLOConfig, ServeConfig, ServeEngine,
                               SymmetricPagePool, TrafficConfig,
                               make_kv_cache, make_requests)


def parse_slo(spec: str) -> tuple[float, float]:
    """``--slo I+B`` class-mix spec -> (interactive_frac, batch_frac);
    the rest of the trace is best_effort."""
    try:
        i, b = spec.split("+")
        ifrac, bfrac = float(i), float(b)
    except ValueError:
        raise SystemExit(
            f"--slo wants I+B fractions (e.g. 0.5+0.25), got "
            f"{spec!r}") from None
    if ifrac < 0 or bfrac < 0 or ifrac + bfrac > 1.0 + 1e-9:
        raise SystemExit(f"--slo {spec}: fractions must be >= 0 and sum "
                         f"to <= 1")
    return ifrac, bfrac


def parse_disagg(spec: str) -> tuple[int, int]:
    """``--disagg P+D`` topology spec -> (n_prefill, n_decode)."""
    try:
        p, d = spec.split("+")
        n_prefill, n_decode = int(p), int(d)
    except ValueError:
        raise SystemExit(
            f"--disagg wants P+D (e.g. 2+2), got {spec!r}") from None
    if n_prefill < 1 or n_decode < 1:
        raise SystemExit(f"--disagg {spec}: both cell counts must be >= 1")
    return n_prefill, n_decode


def build_engine(arch: str = "qwen3-8b", *, config: str = "full",
                 dtype: str = "bf16", device=None, page_tokens: int = 16,
                 n_pages: int = 512, max_batch: int = 8,
                 attn_impl: str = "kernel", prefix_keep: bool = False,
                 prefill_chunk: int = 64, tick_tokens: int = 0,
                 sample_seed: int = 0, seed: int = 0, spec_k: int = 0,
                 draft: str = "ngram", disagg: str = "",
                 router: str = "host", slo=None, ctx=None):
    """The serving engine over ``arch`` with random weights drawn on
    ``device`` from ``seed``.  ``device=None`` is the GPU.  ``draft`` is
    ``"ngram"`` or an arch name: a draft model of that arch (same
    ``config`` size, weights from ``seed + 1``) over a KV cache shared
    with the target.  ``disagg="P+D"`` returns a ``DisaggEngine`` of P
    prefill and D decode cells (speculation there drafts with n-gram,
    as in the reference: a draft arch is replaced by it, with a notice
    on stderr); ``router="amo"`` gives
    it the AMO router and page pools, or, colocated, attaches a
    ``SymmetricPagePool`` to the engine's cache.  ``ctx`` (a
    ``ParallelCtx``; default tp = 1) serves tensor-parallel on the
    stacked team, disaggregated cells one TP group each; the CLI has no
    TP flag, as the reference's has none."""
    if router not in ("host", "amo"):
        raise SystemExit(f"--router wants 'host' or 'amo', got {router!r}")
    if config not in ("full", "smoke"):
        raise ValueError(f"config must be 'full' or 'smoke', got {config!r}")
    dev = resolve(device)
    cfg = configs.get(arch) if config == "full" else configs.get_smoke(arch)
    registry.require_model(cfg)
    dt = dtype_of(dtype)
    scfg = ServeConfig(
        page_tokens=page_tokens, n_pages=n_pages, max_batch=max_batch,
        max_seq=cfg.max_seq, prefill_chunk=prefill_chunk,
        tick_tokens=tick_tokens, attn_impl=attn_impl, dtype=dt,
        prefix_keep=prefix_keep, sample_seed=sample_seed,
        spec_k=spec_k, slo=slo)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = lm.init(gen, cfg, dtype=dt, device=dev)
    if disagg:
        n_prefill, n_decode = parse_disagg(disagg)
        if spec_k > 0 and draft != "ngram":
            print(f"--disagg: the cells draft with the n-gram proposer, as "
                  f"the reference's do; --draft {draft} is not used",
                  file=sys.stderr)
        return DisaggEngine(params, cfg, scfg, ctx=ctx, device=dev,
                            n_prefill=n_prefill, n_decode=n_decode,
                            router=router), cfg
    if spec_k > 0 and draft != "ngram":
        # a draft model on the same page geometry: the shared cache is
        # built first so draft and target index their pools through the
        # same block tables
        kv = make_kv_cache(cfg, scfg, ctx)
        dcfg = configs.get(draft) if config == "full" \
            else configs.get_smoke(draft)
        dgen = torch.Generator(device=dev).manual_seed(seed + 1)
        proposer = DraftModelProposer(
            lm.init(dgen, dcfg, dtype=dt, device=dev), dcfg, scfg, kv,
            target_vocab=cfg.vocab, device=dev, ctx=ctx)
        eng = ServeEngine(params, cfg, scfg, ctx=ctx, device=dev, kv=kv,
                          proposer=proposer)
    else:
        eng = ServeEngine(params, cfg, scfg, ctx=ctx, device=dev)
    if router == "amo":
        # colocated "amo" is the page allocator: the free list moves onto
        # symmetric counter words (the same grants, so streams cannot move)
        eng.kv.attach_pool(SymmetricPagePool(eng.kv.n_pages))
    return eng, cfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b",
                    help="qwen3-8b, gemma-2b, qwen3-moe-30b-a3b or "
                         "qwen2-moe-a2.7b")
    ap.add_argument("--config", default="full", choices=["full", "smoke"])
    ap.add_argument("--dtype", default="bf16", choices=["bf16", "f32"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "plain versions of the kernels)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--rate", type=float, default=8.0,
                    help="Poisson arrival rate (req/s)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--page-tokens", type=int, default=16)
    ap.add_argument("--n-pages", type=int, default=512)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--prefill-chunk", type=int, default=64,
                    help="max prompt tokens one sequence prefills per tick")
    ap.add_argument("--tick-tokens", type=int, default=0,
                    help="per-tick token budget shared by decode+prefill "
                         "(0 = max_batch + prefill_chunk)")
    ap.add_argument("--attn-impl", default="kernel",
                    choices=["ref", "kernel"],
                    help="paged attention for decode AND the prefill "
                         "window: 'kernel' (the CUDA kernels) or 'ref' "
                         "(the plain PyTorch versions)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="per-request sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--sample-seed", type=int, default=0,
                    help="root of the per-(rid, position) RNG streams")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: draft tokens verified per "
                         "sequence per tick (0 = off); token streams are "
                         "unchanged, only ticks shrink")
    ap.add_argument("--draft", default="ngram",
                    help="draft proposer: 'ngram' (prompt-lookup "
                         "self-draft) or an arch name for a draft model "
                         "(e.g. qwen3-8b; its vocab must match)")
    ap.add_argument("--prefix-keep", action="store_true",
                    help="keep finished prompts' full pages as a "
                         "migratable prefix cache")
    ap.add_argument("--disagg", default="",
                    help="disaggregated topology P+D (e.g. 2+2): P prefill "
                         "and D decode cells, put-with-signal page handoff")
    ap.add_argument("--router", default="host", choices=["host", "amo"],
                    help="'amo': CAS admission rings, work stealing and "
                         "symmetric page pools (colocated: the pool only)")
    ap.add_argument("--slo", default="",
                    help="SLO traffic mix 'I+B' (e.g. 0.5+0.25): fractions "
                         "of interactive and batch requests, the rest "
                         "best_effort; turns on priority admission, "
                         "deadline shedding, best-effort degradation and "
                         "(with --tenant-rate) per-tenant fairness")
    ap.add_argument("--ttft", type=float, default=0.25,
                    help="interactive TTFT deadline in seconds (batch gets "
                         "4x, best_effort 8x; 0 = no deadlines)")
    ap.add_argument("--tenants", type=int, default=1,
                    help="tenant ids drawn per request for the fairness "
                         "buckets")
    ap.add_argument("--tenant-rate", type=float, default=0.0,
                    help="per-tenant admission token-bucket refill "
                         "(tokens/tick; 0 = fairness off)")
    ap.add_argument("--hot-swap", action="store_true",
                    help="stream a second weight generation (drawn from "
                         "seed+1000) into the live engine during the run "
                         "and flip atomically mid-serve; swap accounting "
                         "lands in metrics()['swap']")
    ap.add_argument("--trace", action="store_true",
                    help="print the per-request decode trace")
    args = ap.parse_args(argv)

    slo_cfg, slo_tkw = None, {}
    if args.slo:
        ifrac, bfrac = parse_slo(args.slo)
        ttft = args.ttft if args.ttft > 0 else None
        slo_cfg = SLOConfig(
            ttft_interactive=ttft,
            ttft_batch=4 * ttft if ttft else None,
            ttft_best_effort=8 * ttft if ttft else None,
            tenant_rate=args.tenant_rate,
            tenant_burst=2 * args.tenant_rate)
        slo_tkw = dict(interactive_frac=ifrac, batch_frac=bfrac,
                       deadline_interactive=slo_cfg.ttft_interactive,
                       deadline_batch=slo_cfg.ttft_batch,
                       deadline_best_effort=slo_cfg.ttft_best_effort,
                       n_tenants=args.tenants)

    eng, cfg = build_engine(
        args.arch, config=args.config, dtype=args.dtype, device=args.device,
        page_tokens=args.page_tokens, n_pages=args.n_pages,
        max_batch=args.max_batch, attn_impl=args.attn_impl,
        prefill_chunk=args.prefill_chunk, tick_tokens=args.tick_tokens,
        sample_seed=args.sample_seed, seed=args.seed, spec_k=args.spec_k,
        draft=args.draft, prefix_keep=args.prefix_keep, disagg=args.disagg,
        router=args.router, slo=slo_cfg)
    tcfg = TrafficConfig(n_requests=args.requests, rate=args.rate,
                         vocab=cfg.vocab, seed=args.seed,
                         temperature=args.temperature, top_k=args.top_k,
                         top_p=args.top_p, **slo_tkw)
    reqs = make_requests(tcfg)
    if args.hot_swap:
        dev = eng.device
        gen = torch.Generator(device=dev).manual_seed(args.seed + 1000)
        eng.begin_hot_swap(lm.init(gen, cfg, dtype=dtype_of(args.dtype),
                                   device=dev))
    print(f"arch={cfg.name} device={eng.device} dtype={args.dtype} "
          f"pages={args.n_pages}x{args.page_tokens} "
          f"batch={args.max_batch} chunk={args.prefill_chunk} "
          f"attn={args.attn_impl} sampling=(T={args.temperature} "
          f"k={args.top_k} p={args.top_p}) spec=(k={args.spec_k} "
          f"draft={args.draft}) slo={args.slo or 'off'} "
          f"prefix_keep={args.prefix_keep} "
          f"topology={args.disagg or 'colocated'} router={args.router} "
          f"hot_swap={args.hot_swap} requests={len(reqs)}")
    done = eng.run(reqs)
    if args.trace:
        for r in sorted(done, key=lambda r: r.rid):
            print(f"  req{r.rid}: prompt[{r.n_prompt}] "
                  f"chunks={r.prefill_chunks} -> "
                  f"{r.out[:10]}{'...' if len(r.out) > 10 else ''} "
                  f"({len(r.out)} tokens, {r.preemptions} preemptions)")
    print(json.dumps(eng.metrics(), indent=2))


if __name__ == "__main__":
    main()
