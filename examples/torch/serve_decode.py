"""Serving example on the PyTorch port: greedy decode of a batch with the
contiguous KV cache (a ring cache under sliding-window configs; the
recurrent state for the RWKV and Mamba families).

    PYTHONPATH=src python examples/torch/serve_decode.py \\
        --arch h2o-danube-3-4b [--device cpu]
"""
import argparse
import time

import torch

from repro_torch import configs
from repro_torch.device import resolve
from repro_torch.models import registry
from repro_torch.parallel import ParallelCtx


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-3-4b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "plain versions)")
    args = ap.parse_args(argv)

    dev = resolve(args.device)
    cfg = configs.get_smoke(args.arch)
    ctx = ParallelCtx(sp=False, remat=False, param_dtype=torch.float32,
                      compute_dtype=torch.float32)
    api = registry.build(cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(0), cfg,
                      device=dev)

    b = args.batch
    state = api.init_decode_state(cfg, ctx, b, max_len=64, device=dev)
    tok = torch.randint(0, cfg.vocab, (b,),
                        generator=torch.Generator(device=dev).manual_seed(1),
                        device=dev)
    outs = [tok]
    t0 = time.time()
    with torch.no_grad():
        for _ in range(args.new_tokens):
            tok, state = api.decode_step(params, tok, state, ctx, cfg)
            outs.append(tok)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    seqs = torch.stack(outs, dim=1).tolist()
    print(f"{cfg.name}: decoded {args.new_tokens} tokens x {b} requests "
          f"on {dev} in {dt:.2f}s ({b * args.new_tokens / dt:.1f} tok/s)")
    for i in range(min(b, 2)):
        print(f"  req{i}: {seqs[i][:12]}...")
    return seqs


if __name__ == "__main__":
    main()
