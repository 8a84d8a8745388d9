"""Training CLI on one card: gemma-2b / qwen3-8b (dense family) with
AdamW, f32 parameters and f32 compute, as the reference's launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
        --steps 3 --global-batch 8 --microbatches 8

Runs on the GPU; ``--device cpu`` runs the plain CPU versions (with
``--smoke``, the reduced config).  On the card the attention forward
runs the flash kernel (``build_trainer(attn_impl="ref")`` takes its
plain version).  f32 matrix products are kept in full f32: TF32 is switched
off for matmuls and cuDNN (``torch.backends.*.allow_tf32 = False``),
since TF32 would change the numbers the reference computes.

Not in this slice (the flags are not accepted): ``--backend``,
``--bucket-bytes`` and ``--overlap-grad-sync`` need dp > 1 (ROADMAP
A5/A6); ``--ckpt-dir``, ``--ckpt-every`` and ``--resume`` wait for the
checkpoint port (A9).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import configs
from repro_torch.data import SyntheticLM
from repro_torch.device import resolve
from repro_torch.models import registry
from repro_torch.parallel import ParallelCtx
from repro_torch.train import AdamWConfig, init_train_state, make_train_step


@dataclasses.dataclass
class Trainer:
    cfg: object
    ctx: ParallelCtx
    state: dict
    step_fn: object
    data: SyntheticLM
    device: torch.device

    def step(self, s: int) -> dict:
        """Train on batch ``s``; host-clock seconds include the batch's
        transfer and end in a device synchronize."""
        t0 = time.monotonic()
        batch = self.data.batch(s, device=self.device)
        self.state, m = self.step_fn(self.state, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return {"step": m["step"], "loss": loss, "grad_norm": gnorm,
                "seconds": time.monotonic() - t0}


def build_trainer(arch: str = "gemma-2b", *, smoke: bool = False,
                  global_batch: int = 8, microbatches: int = 1,
                  zero: int = 0, lr: float = 3e-4, device=None,
                  attn_impl: str = "kernel", seed: int = 0) -> Trainer:
    """A trainer over ``arch`` (the published config, or ``smoke``) with
    f32 parameters drawn on ``device`` (None: the GPU) from ``seed``,
    data from ``SyntheticLM`` at ``cfg.max_seq`` tokens per row."""
    dev = resolve(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.get_smoke(arch) if smoke else configs.get(arch)
    ctx = ParallelCtx(remat=True, attn_impl=attn_impl,
                      param_dtype=torch.float32, compute_dtype=torch.float32)
    api = registry.build(cfg)
    opt = AdamWConfig(lr=lr, zero=zero)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = init_train_state(gen, cfg, ctx, api, opt, device=dev)
    step_fn = make_train_step(cfg, ctx, api, opt, microbatches=microbatches)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=cfg.max_seq,
                       global_batch=global_batch)
    return Trainer(cfg, ctx, state, step_fn, data, dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced-config variant")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--zero", type=int, default=0, choices=[0, 1])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "plain versions of the kernels)")
    args = ap.parse_args(argv)
    tr = build_trainer(args.arch, smoke=args.smoke,
                       global_batch=args.global_batch,
                       microbatches=args.microbatches, zero=args.zero,
                       lr=args.lr, device=args.device)
    print(f"device {tr.device} zero={args.zero} microbatches="
          f"{args.microbatches} arch={tr.cfg.name}", flush=True)
    for s in range(args.steps):
        m = tr.step(s)
        if s % 5 == 0 or s == args.steps - 1:
            print(f"step {s:4d}  loss {m['loss']:.4f}  {m['seconds']:.2f}s",
                  flush=True)
    print("training complete")


if __name__ == "__main__":
    main()
