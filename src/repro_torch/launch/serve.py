"""Serving CLI: continuous batching over the paged symmetric-heap KV
cache with seeded synthetic traffic, on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \\
        --requests 8 --page-tokens 16 --n-pages 512 --max-batch 8 \\
        --prefill-chunk 64

``--config full`` (the default) serves the published config at full
width in bf16 with random weights made on the card from ``--seed``;
``--config smoke`` the reduced CPU-test config.  The engine runs on the
card; ``--device cpu`` runs the plain CPU versions of the kernels.
Prints per-request traces with ``--trace``, then the
throughput/latency summary.

Not in this slice of the port (each raises ``NotImplementedError``):
``--spec-k``, ``--slo``, ``--disagg``, ``--router amo``, ``--hot-swap``.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch import configs
from repro_torch.device import dtype_of, resolve
from repro_torch.models import lm
from repro_torch.serve import ServeConfig, ServeEngine, TrafficConfig, \
    make_requests


def build_engine(arch: str = "qwen3-8b", *, config: str = "full",
                 dtype: str = "bf16", device=None, page_tokens: int = 16,
                 n_pages: int = 512, max_batch: int = 8,
                 attn_impl: str = "kernel", prefix_keep: bool = False,
                 prefill_chunk: int = 64, tick_tokens: int = 0,
                 sample_seed: int = 0, seed: int = 0, spec_k: int = 0,
                 disagg: str = "", router: str = "host", slo=None):
    """The colocated serving engine over ``arch`` with random weights
    drawn on ``device`` from ``seed``.  ``device=None`` is the GPU."""
    if disagg:
        raise NotImplementedError(
            "disaggregated prefill/decode cells (serve/disagg.py) arrive "
            "with the control-plane slice of the port")
    if router not in ("host", "amo"):
        raise ValueError(f"router must be 'host' or 'amo', got {router!r}")
    if router == "amo":
        raise NotImplementedError(
            "the AMO page pool and router (serve/page_pool.py, "
            "serve/amo_router.py) arrive with the control-plane slice")
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
    return ServeEngine(params, cfg, scfg, device=dev), cfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
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
                    help="speculative decoding (a later slice)")
    ap.add_argument("--disagg", default="",
                    help="disaggregated topology P+D (a later slice)")
    ap.add_argument("--router", default="host", choices=["host", "amo"])
    ap.add_argument("--slo", default="", help="SLO mix I+B (a later slice)")
    ap.add_argument("--hot-swap", action="store_true",
                    help="weight hot-swap (a later slice)")
    ap.add_argument("--trace", action="store_true",
                    help="print the per-request decode trace")
    args = ap.parse_args(argv)
    if args.slo:
        raise NotImplementedError(
            "the SLO policy (serve/slo.py) arrives in the SLO slice of the "
            "port")
    if args.hot_swap:
        raise NotImplementedError(
            "weight hot-swap (ckpt/hotswap.py) arrives with the checkpoint "
            "slice of the port")

    eng, cfg = build_engine(
        args.arch, config=args.config, dtype=args.dtype, device=args.device,
        page_tokens=args.page_tokens, n_pages=args.n_pages,
        max_batch=args.max_batch, attn_impl=args.attn_impl,
        prefill_chunk=args.prefill_chunk, tick_tokens=args.tick_tokens,
        sample_seed=args.sample_seed, seed=args.seed, spec_k=args.spec_k,
        disagg=args.disagg, router=args.router)
    tcfg = TrafficConfig(n_requests=args.requests, rate=args.rate,
                         vocab=cfg.vocab, seed=args.seed,
                         temperature=args.temperature, top_k=args.top_k,
                         top_p=args.top_p)
    reqs = make_requests(tcfg)
    print(f"arch={cfg.name} device={eng.device} dtype={args.dtype} "
          f"pages={args.n_pages}x{args.page_tokens} "
          f"batch={args.max_batch} chunk={args.prefill_chunk} "
          f"attn={args.attn_impl} sampling=(T={args.temperature} "
          f"k={args.top_k} p={args.top_p}) requests={len(reqs)}")
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
