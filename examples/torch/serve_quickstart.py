"""Serving quickstart on the PyTorch port: a 3-request continuous-batching
decode trace over the paged symmetric-heap KV cache.

    PYTHONPATH=src python examples/torch/serve_quickstart.py [--device cpu]

On the GPU the decode and prefill windows run the paged-attention CUDA
kernels; ``--device cpu`` (or ``--attn-impl ref``) their plain versions.
What to look for in the output:

  * tick 1 admits all three requests FCFS and starts CHUNKED prefill —
    each prompt's K/V lands in fixed-size PAGES, and each request's cache
    is a BLOCK TABLE of page ids (printed per request).  Page ids are
    symmetric addresses: the same table is valid on every PE (POSH Fact
    1 at page granularity), which is what makes moving pages between
    PEs a one-sided ``put_nbi``.
  * prefill is TOKEN-BUDGETED: each tick hands every prefilling request
    up to ``prefill_chunk`` prompt tokens from a budget shared with
    decode (decode claims first), so the ``prefill i/n`` counters advance
    a chunk a tick.
  * every later tick decodes ONE token for EVERY decoding request in a
    single batched step (continuous batching), and a request that
    finishes frees its pages for the next admission.
"""
import argparse

import torch

from repro_torch import configs, serve
from repro_torch.device import resolve
from repro_torch.models import registry


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "plain versions)")
    ap.add_argument("--attn-impl", default="kernel", choices=["kernel", "ref"])
    args = ap.parse_args(argv)

    dev = resolve(args.device)
    cfg = configs.get_smoke("qwen3-8b")
    params = registry.build(cfg).init(
        torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    scfg = serve.ServeConfig(page_tokens=4, n_pages=16, max_batch=3,
                             max_seq=32, prefill_chunk=4,
                             attn_impl=args.attn_impl)
    eng = serve.ServeEngine(params, cfg, scfg, device=dev)

    reqs = [serve.Request(rid=0, prompt=[11, 12, 13, 14, 15, 16], max_new=5),
            serve.Request(rid=1, prompt=[50, 51, 52], max_new=7),
            serve.Request(rid=2, prompt=[90, 91, 92, 93, 94, 95, 96, 97],
                          max_new=3)]
    for r in reqs:
        eng.submit(r)

    print(f"pool: {scfg.n_pages} pages x {scfg.page_tokens} tokens "
          f"(page 0 = null), {cfg.n_layers} layers, device {dev}")
    while eng.sched.has_work():
        eng.tick(now=float(eng.ticks))
        running = {r.rid: (f"prefill {r.n_done}/{r.n_prompt}"
                           if r.is_prefilling()
                           else f"decode {len(r.out)}/{r.max_new}")
                   for r in eng.sched.running}
        tables = {r.rid: eng.kv.tables[r.rid] for r in eng.sched.running}
        print(f"tick {eng.ticks}: running={running} "
              f"block_tables={tables} free_pages={eng.kv.n_free()}")

    print("\ndecoded streams (greedy):")
    for r in sorted(eng.finished, key=lambda r: r.rid):
        print(f"  req{r.rid}: prompt={r.prompt} -> {r.out}")
    m = eng.metrics()
    print(f"\n{m['tokens_out']} tokens over {m['ticks']} ticks; "
          f"scheduler: {m['sched']}")
    return {r.rid: list(r.out) for r in eng.finished}


if __name__ == "__main__":
    main()
