"""End-to-end training driver on the PyTorch port: a decoder LM trained
for a few hundred steps with asynchronous checkpoints, restart safety
and the POSH collective backend.

    PYTHONPATH=src python examples/torch/train_lm.py --preset small \\
        --steps 200 [--device cpu] [--resume]

Presets: small (~4M parameters, CPU-friendly), 100m (~100M — the
deliverable configuration, sized for the card).  Loss on the synthetic
bigram corpus falls well below the uniform baseline within a few
hundred steps.  Checkpoints (every ``--ckpt-every`` steps, under
``--ckpt-dir``) hold the reference's tree layout, so ``--resume``
continues from the newest.
"""
import argparse
import math
import os
import tempfile
import time

import torch

from repro_torch.ckpt import Checkpointer
from repro_torch.configs.base import ArchConfig
from repro_torch.data import SyntheticLM
from repro_torch.device import resolve
from repro_torch.launch.train import Trainer
from repro_torch.models import registry
from repro_torch.parallel import ParallelCtx
from repro_torch.train import AdamWConfig, init_train_state, make_train_step
from repro_torch.train.tree import leaves

PRESETS = {
    "small": ArchConfig(name="lm-small", family="dense", n_layers=4,
                        d_model=256, n_heads=4, n_kv=2, head_dim=64,
                        d_ff=768, vocab=2048, act="swiglu", max_seq=128),
    "100m": ArchConfig(name="lm-100m", family="dense", n_layers=12,
                       d_model=768, n_heads=12, n_kv=4, head_dim=64,
                       d_ff=2304, vocab=32768, act="swiglu", max_seq=512),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="small", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--backend", default="posh", choices=["posh", "xla"])
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "plain versions)")
    args = ap.parse_args(argv)

    dev = resolve(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = PRESETS[args.preset]
    ctx = ParallelCtx(sp=False, remat=True, backend=args.backend,
                      param_dtype=torch.float32, compute_dtype=torch.float32)
    api = registry.build(cfg)
    opt = AdamWConfig(lr=6e-4, weight_decay=0.01)
    state = init_train_state(torch.Generator(device=dev).manual_seed(0), cfg,
                             ctx, api, opt, device=dev)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=cfg.max_seq,
                       global_batch=args.batch)
    tr = Trainer(cfg, ctx, state, make_train_step(cfg, ctx, api, opt), data,
                 dev)
    ck = Checkpointer(args.ckpt_dir, keep=2)
    start = tr.restore(ck) if args.resume else 0
    if args.resume:
        print(f"resumed from step {start}")
    n = sum(p.numel() for p in leaves(state["params"]))
    print(f"{cfg.name}: {n / 1e6:.1f}M params, backend={args.backend}, "
          f"device={dev}, uniform-baseline loss={math.log(cfg.vocab):.3f}")
    t0, out = time.time(), []
    for s in range(start, args.steps):
        m = tr.step(s)
        out.append(m)
        if s % 10 == 0 or s == args.steps - 1:
            toks = args.batch * cfg.max_seq
            dt = (time.time() - t0) / (s - start + 1)
            print(f"step {s:4d}  loss {m['loss']:.4f}  {toks / dt:,.0f} tok/s")
        if (s + 1) % args.ckpt_every == 0:
            tr.save(ck, s + 1)
    ck.wait()
    print("done.")
    return out


if __name__ == "__main__":
    main()
