"""Training CLI on one card with AdamW, f32 parameters and f32 compute,
as the reference's launcher.  ``--arch`` takes the dense configs
(gemma-2b, qwen3-8b, minitron-4b, h2o-danube-3-4b), the MoE configs
(qwen3-moe-30b-a3b, qwen2-moe-a2.7b; ``--layers N`` keeps the first N
at published width), rwkv6-3b (RWKV) and zamba2-7b (Mamba2 groups with
a shared attention block).  whisper-base and
llama-3.2-vision-90b train on batches that carry ``frames`` /
``img_embeds`` beside the tokens, which the synthetic data (token-only,
as the reference's ``SyntheticLM``) does not make: the CLI raises for
them, naming the key; drive ``train.make_train_step`` with such a batch
(README).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
        --steps 3 --global-batch 8 --microbatches 8

Runs on the GPU; ``--device cpu`` runs the plain CPU versions (with
``--smoke``, the reduced config).  ``--layers N`` keeps the first N
layers of the published width, a depth cut the reference's CLI does
not have: it exists for ``chip_smoke.py``'s stages (a full f32
checkpoint of gemma-2b is 30 GB; zamba2-7b's state, 108 GB, does not fit
the card).  For zamba2-7b N must be a multiple of the group size
(``shared_attn_every``, 6): the cut keeps N / 6 whole groups, each
followed by the shared block, and no tail.  On the card the attention forward
runs the flash kernel (``build_trainer(attn_impl="ref")`` takes its
plain version).  f32 matrix products are kept in full f32: TF32 is switched
off for matmuls and cuDNN (``torch.backends.*.allow_tf32 = False``),
since TF32 would change the numbers the reference computes.

Checkpoint/restart as the reference's launcher: every ``--ckpt-every``
steps the state is saved asynchronously under ``--ckpt-dir`` (default
``repro_train_ckpt`` in the temporary directory; the newest 3 kept) in
the reference's layout (``train.step.state_to_tree``), so a JAX
checkpoint resumes here and the reverse; ``--resume`` loads the newest
and continues from its step.  Each step's time is recorded with a
``StragglerPolicy`` (600 s deadline).

``--backend`` (posh | xla, default posh), ``--bucket-bytes`` and
``--overlap-grad-sync`` are the reference's: they pick the DP
communicator's transport and the DP gradient reduction's schedule.  As
in the reference, the CLI's DP size is the device count, one here, so at
dp = 1 they change nothing.  ``build_trainer(dp_size=N, ...)`` trains N
replicas on the stacked team of one card (ROADMAP A6), with the same
options and ``compress`` (none | bf16 | int8) besides, and
``build_trainer(tp_size=T, moe_dispatch=...)`` trains any family the
synthetic data feeds at TP T on the stacked team (every PE's shards on one card,
sequence parallelism on, as the reference's launcher sets ``sp = tp >
1``); the CLI, like the reference's on one device, runs at tp = 1.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch import configs
from repro_torch.ckpt import Checkpointer
from repro_torch.data import SyntheticLM
from repro_torch.device import resolve
from repro_torch.ft import StragglerPolicy
from repro_torch.models import registry
from repro_torch.parallel import ParallelCtx
from repro_torch.train import (AdamWConfig, init_train_state, make_train_step,
                               state_from_tree, state_to_tree)
from repro_torch.train.tree import tree_map


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

    def save(self, ck: Checkpointer, step: int) -> None:
        """Save the state asynchronously as checkpoint ``step``, in the
        reference's layout: restacked into new host tensors, which are
        the snapshot (handed over as numpy arrays, which ``save_async``
        takes as they are), then written on ``ck``'s worker thread."""
        host = state_to_tree(self.state, device="cpu", cfg=self.cfg,
                             ctx=self.ctx)
        ck.save_async(step, tree_map(lambda t: t.numpy(), host))

    def restore(self, ck: Checkpointer, step=None) -> int:
        """Load the newest (or the given) checkpoint of ``ck`` into the
        state in place; returns its step."""
        tree, step = ck.restore(state_to_tree(
            self.state, device="meta", cfg=self.cfg, ctx=self.ctx), step)
        state_from_tree(self.state, tree, cfg=self.cfg, ctx=self.ctx)
        return step


# the batch key each family trains on beside the tokens
_INPUTS = {"encdec": "frames", "vlm": "img_embeds"}


def cut_layers(cfg, n_layers: int):
    """``cfg`` with its first ``n_layers`` layers (0: all).  A hybrid
    keeps whole groups (``n_layers`` must divide by its group size), as
    does the vlm (a multiple of ``cross_attn_every``: each group's dense
    layers and its cross layer); an encoder-decoder keeps ``n_layers``
    encoder and decoder layers each, as the reference's dry run cuts
    it."""
    if not n_layers:
        return cfg
    for k, what in ((cfg.shared_attn_every, "Mamba layers"),
                    (cfg.cross_attn_every, "layers (dense + cross)")):
        if k and n_layers % k:
            raise ValueError(f"{cfg.name}: --layers {n_layers} must keep "
                             f"whole groups of {k} {what} (a multiple of "
                             f"{k})")
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, n_layers=n_layers,
                                   enc_layers=n_layers)
    return dataclasses.replace(cfg, n_layers=n_layers)


def build_trainer(arch: str = "gemma-2b", *, smoke: bool = False,
                  global_batch: int = 8, microbatches: int = 1,
                  zero: int = 0, lr: float = 3e-4, device=None,
                  attn_impl: str = "kernel", seed: int = 0,
                  n_layers: int = 0, seq_len: int = 0, dp_size: int = 1,
                  tp_size: int = 1, moe_dispatch: str = "einsum",
                  backend: str = "posh", bucket_bytes: int = 0,
                  overlap_grad_sync: bool = False,
                  compress: str = "none") -> Trainer:
    """A trainer over ``arch`` (the published config, or ``smoke``; its
    first ``n_layers`` layers when that is not 0, ``cut_layers``) with
    f32 parameters drawn on ``device`` (None: the GPU) from ``seed``,
    data from ``SyntheticLM`` at ``seq_len`` tokens per row (0:
    ``cfg.max_seq``): ``dp_size``
    replicas on the stacked team, each on its ``global_batch / dp_size``
    rows in ``microbatches`` microbatches, their gradients reduced
    through the ``backend``'s DP communicator by the schedule
    ``bucket_bytes`` / ``overlap_grad_sync`` / ``compress`` choose; each
    replica a TP group of ``tp_size`` PEs (``moe_dispatch`` einsum |
    alltoall for a MoE config), with sequence parallelism at
    ``tp_size`` > 1."""
    cfg = configs.get_smoke(arch) if smoke else configs.get(arch)
    registry.require_model(cfg)
    cfg = cut_layers(cfg, n_layers)
    if cfg.family in _INPUTS:
        raise ValueError(
            f"{cfg.name} trains on batches with {_INPUTS[cfg.family]!r} "
            f"beside 'tokens', and the synthetic data is token-only (as the "
            f"reference's SyntheticLM): build the batch and call "
            f"train.make_train_step")
    dev = resolve(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = ParallelCtx(dp_size=dp_size, tp_size=tp_size, backend=backend,
                      remat=True, attn_impl=attn_impl,
                      moe_dispatch=moe_dispatch, param_dtype=torch.float32,
                      compute_dtype=torch.float32)
    api = registry.build(cfg)
    opt = AdamWConfig(lr=lr, zero=zero)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = init_train_state(gen, cfg, ctx, api, opt, device=dev)
    step_fn = make_train_step(cfg, ctx, api, opt, microbatches=microbatches,
                              bucket_bytes=bucket_bytes, compress=compress,
                              overlap_grad_sync=overlap_grad_sync)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=seq_len or cfg.max_seq,
                       global_batch=global_batch)
    return Trainer(cfg, ctx, state, step_fn, data, dev)


def main(argv=None) -> list:
    """The CLI; returns the per-step metrics of the steps it ran."""
    ap = argparse.ArgumentParser(description=" ".join(
        __doc__.split("\n\n")[0].split()))
    ap.add_argument("--arch", default="gemma-2b",
                    help="gemma-2b, qwen3-8b, minitron-4b, h2o-danube-3-4b "
                         "(dense), qwen3-moe-30b-a3b, qwen2-moe-a2.7b (MoE), "
                         "rwkv6-3b (RWKV), zamba2-7b (Mamba2 + shared "
                         "attention)")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced-config variant")
    ap.add_argument("--layers", type=int, default=0,
                    help="keep the config's first N layers (0: all; a "
                         "depth cut for chip_smoke.py's stages); zamba2-7b "
                         "keeps whole groups: N a multiple of 6")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--backend", default="posh", choices=["posh", "xla"])
    ap.add_argument("--zero", type=int, default=0, choices=[0, 1])
    ap.add_argument("--bucket-bytes", type=int, default=0,
                    help="DP grad bucketing (0 = per-leaf reductions)")
    ap.add_argument("--overlap-grad-sync", action="store_true",
                    help="issue DP reductions nonblocking and drain "
                         "with one quiet() before the optimizer "
                         "(paper §3.2 overlap; bit-identical losses)")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "plain versions of the kernels)")
    args = ap.parse_args(argv)
    tr = build_trainer(args.arch, smoke=args.smoke,
                       global_batch=args.global_batch,
                       microbatches=args.microbatches, zero=args.zero,
                       lr=args.lr, device=args.device, n_layers=args.layers,
                       backend=args.backend, bucket_bytes=args.bucket_bytes,
                       overlap_grad_sync=args.overlap_grad_sync)
    ck = Checkpointer(args.ckpt_dir, keep=3)
    start = 0
    if args.resume:
        start = tr.restore(ck)
        print(f"resumed at step {start}")
    straggler = StragglerPolicy(deadline_s=600.0)
    print(f"device {tr.device} backend={args.backend} zero={args.zero} "
          f"microbatches={args.microbatches} arch={tr.cfg.name}", flush=True)
    out = []
    for s in range(start, args.steps):
        m = tr.step(s)
        straggler.record(0, m["seconds"])
        out.append(m)
        if s % 5 == 0 or s == args.steps - 1:
            print(f"step {s:4d}  loss {m['loss']:.4f}  {m['seconds']:.2f}s",
                  flush=True)
        if (s + 1) % args.ckpt_every == 0:
            tr.save(ck, s + 1)
    ck.wait()
    print("training complete")
    return out


if __name__ == "__main__":
    main()
