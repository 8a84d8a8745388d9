"""Quickstart on the PyTorch port: train a tiny LM through the POSH
communication layer.

    PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]

Runs ``--steps`` steps of a smoke-size config (``--arch``) on the GPU, or
on the CPU with ``--device cpu`` (the plain versions of the kernels),
and prints a decreasing loss.  Every collective in the step (the TP
completion and the DP mean — the identity at one PE, but the same code
path) goes through a ``Communicator`` built by the ``ParallelCtx``, with
the paper's put/get schedules under ``--backend posh``::

    tp = comm.make_communicator("model", size=8, backend="posh")
    y = tp.psum(x)                   # x stacked (8, ...): every PE's shard
    tp.stats()                       # {"psum": {"calls", "bytes", "algos"}}
"""
import argparse

import torch

from repro_torch import configs
from repro_torch.data import SyntheticLM
from repro_torch.device import resolve
from repro_torch.models import registry
from repro_torch.parallel import ParallelCtx
from repro_torch.train import AdamWConfig, init_train_state, make_train_step
from repro_torch.train.tree import leaves


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b",
                    help="architecture id (its smoke-size config is used)")
    ap.add_argument("--backend", default="posh", choices=["posh", "xla"])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "plain versions)")
    args = ap.parse_args(argv)

    dev = resolve(args.device)
    cfg = configs.get_smoke(args.arch)
    ctx = ParallelCtx(sp=False, remat=True, backend=args.backend,
                      param_dtype=torch.float32, compute_dtype=torch.float32)
    api = registry.build(cfg)
    opt = AdamWConfig(lr=1e-3)
    state = init_train_state(torch.Generator(device=dev).manual_seed(0), cfg,
                             ctx, api, opt, device=dev)
    step = make_train_step(cfg, ctx, api, opt)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=cfg.max_seq, global_batch=8)
    n = sum(p.numel() for p in leaves(state["params"]))
    print(f"arch={cfg.name} backend={args.backend} device={dev} "
          f"params={n:,}")
    losses = []
    for s in range(args.steps):
        state, m = step(state, data.batch(s, device=dev))
        losses.append(float(m["loss"]))
        if s % 5 == 0 or s == args.steps - 1:
            print(f"step {s:3d}  loss {losses[-1]:.4f}  "
                  f"|g| {float(m['grad_norm']):.3f}")
    for name, c in (("tp", ctx.tp_comm), ("dp", ctx.dp_comm)):
        print(f"{name}_comm stats: {c.stats()}")
    return losses


if __name__ == "__main__":
    main()
