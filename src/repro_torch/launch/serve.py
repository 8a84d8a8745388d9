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
pages as a migratable prefix cache.  For a dense model none of these
changes a token: speculation and migration only change how many ticks
a stream takes.  A MoE model's streams are the same only while no
expert's capacity drops a token: drops depend on which tokens share a
step, in the reference as here.
Prints per-request traces with ``--trace``, then the
throughput/latency summary (with its ``spec`` and ``slo`` blocks).

Not ported yet (each raises ``NotImplementedError``): ``--disagg`` and
``--router amo`` (A8, the control plane), ``--hot-swap`` (A9).
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch import configs
from repro_torch.core.heap import SymmetricHeap
from repro_torch.device import dtype_of, resolve
from repro_torch.models import lm
from repro_torch.serve import (DraftModelProposer, PagedKVCache, SLOConfig,
                               ServeConfig, ServeEngine, TrafficConfig,
                               make_requests)


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


def build_engine(arch: str = "qwen3-8b", *, config: str = "full",
                 dtype: str = "bf16", device=None, page_tokens: int = 16,
                 n_pages: int = 512, max_batch: int = 8,
                 attn_impl: str = "kernel", prefix_keep: bool = False,
                 prefill_chunk: int = 64, tick_tokens: int = 0,
                 sample_seed: int = 0, seed: int = 0, spec_k: int = 0,
                 draft: str = "ngram", disagg: str = "",
                 router: str = "host", slo=None):
    """The colocated serving engine over ``arch`` with random weights
    drawn on ``device`` from ``seed``.  ``device=None`` is the GPU.
    ``draft`` is ``"ngram"`` or an arch name: a draft model of that arch
    (same ``config`` size, weights from ``seed + 1``) over a KV cache
    shared with the target."""
    if disagg:
        raise NotImplementedError(
            "disaggregated prefill/decode cells (serve/disagg.py) arrive "
            "with the control-plane slice of the port (A8)")
    if router not in ("host", "amo"):
        raise ValueError(f"router must be 'host' or 'amo', got {router!r}")
    if router == "amo":
        raise NotImplementedError(
            "the AMO page pool and router (serve/page_pool.py, "
            "serve/amo_router.py) arrive with the control-plane slice (A8)")
    if config not in ("full", "smoke"):
        raise ValueError(f"config must be 'full' or 'smoke', got {config!r}")
    dev = resolve(device)
    cfg = configs.get(arch) if config == "full" else configs.get_smoke(arch)
    dt = dtype_of(dtype)
    scfg = ServeConfig(
        page_tokens=page_tokens, n_pages=n_pages, max_batch=max_batch,
        max_seq=cfg.max_seq, prefill_chunk=prefill_chunk,
        tick_tokens=tick_tokens, attn_impl=attn_impl, dtype=dt,
        prefix_keep=prefix_keep, sample_seed=sample_seed,
        spec_k=spec_k, slo=slo)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = lm.init(gen, cfg, dtype=dt, device=dev)
    if spec_k > 0 and draft != "ngram":
        # a draft model on the same page geometry: the shared cache is
        # built first so draft and target index their pools through the
        # same block tables
        kv = PagedKVCache(
            SymmetricHeap(("data",)), n_layers=cfg.n_layers,
            kv_heads=cfg.kv_per_rank(1), head_dim=cfg.head_dim,
            n_pages=n_pages, page_tokens=page_tokens, dtype=dt)
        dcfg = configs.get(draft) if config == "full" \
            else configs.get_smoke(draft)
        dgen = torch.Generator(device=dev).manual_seed(seed + 1)
        proposer = DraftModelProposer(
            lm.init(dgen, dcfg, dtype=dt, device=dev), dcfg, scfg, kv,
            target_vocab=cfg.vocab, device=dev)
        return ServeEngine(params, cfg, scfg, device=dev, kv=kv,
                           proposer=proposer), cfg
    return ServeEngine(params, cfg, scfg, device=dev), cfg


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
                    help="disaggregated topology P+D (not ported: A8)")
    ap.add_argument("--router", default="host", choices=["host", "amo"])
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
                    help="weight hot-swap (not ported: A9)")
    ap.add_argument("--trace", action="store_true",
                    help="print the per-request decode trace")
    args = ap.parse_args(argv)
    if args.hot_swap:
        raise NotImplementedError(
            "weight hot-swap (ckpt/hotswap.py) arrives with the checkpoint "
            "slice of the port (A9)")

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
    print(f"arch={cfg.name} device={eng.device} dtype={args.dtype} "
          f"pages={args.n_pages}x{args.page_tokens} "
          f"batch={args.max_batch} chunk={args.prefill_chunk} "
          f"attn={args.attn_impl} sampling=(T={args.temperature} "
          f"k={args.top_k} p={args.top_p}) spec=(k={args.spec_k} "
          f"draft={args.draft}) slo={args.slo or 'off'} "
          f"prefix_keep={args.prefix_keep} requests={len(reqs)}")
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
