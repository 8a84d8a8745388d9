"""The plain reference of a training step of a dense Qwen3 decoder:
float32 parameters and products (TF32 off unless ``tf32``), the mean
next-token cross-entropy over the step's rows, gradients averaged over
its microbatches, the global gradient norm clipped to ``clip_norm``,
and AdamW (bias corrections in float32, weight decay on every
parameter), written from the published algorithm.

It draws the same seeded weights and batches the benchmark handed to
the program (``lib.weights``, ``lib.gen``) and nothing the program made,
and reports what the check compares: each step's loss, each parameter's
gradient norm at the first step (after the clip, as the optimizer gets
it) and each parameter's distance from its first value after the last
step.  ``half_batch`` leaves half of each step's rows out (the mean
taken over the rest): a fault the check must see.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.lib import gen, weights
from perfbench.reference.decoder import attention, rms, rope


def leaf_names(cfg: dict) -> list:
    """Every parameter's name: ``embed``, ``head`` (unless tied),
    ``ln_f`` and ``L<i>.<name>`` for each layer's tensors."""
    names = ["embed", "ln_f"] + ([] if weights.tied(cfg) else ["head"])
    for li in range(weights.dims(cfg)["layers"]):
        names += [f"L{li}.{n}" for n, _, _ in weights.layer_shapes(cfg)]
    return names


def initial_groups(cfg: dict, seed: int, device):
    """The first values of every parameter, float32, by name: the tables,
    then each layer's, one group at a time (so that one group is held at
    once)."""
    f32 = torch.float32
    yield {n: weights.table(cfg, seed, n, f32, device)
           for n in ("embed", "ln_f", "head")
           if n != "head" or not weights.tied(cfg)}
    for li in range(weights.dims(cfg)["layers"]):
        yield {f"L{li}.{n}": t
               for n, t in weights.layer(cfg, seed, li, f32, device).items()}


def initial(cfg: dict, seed: int, device) -> dict:
    """The first values of every parameter, float32, by name."""
    return {n: t for group in initial_groups(cfg, seed, device)
            for n, t in group.items()}


def changes(params: dict, cfg: dict, seed: int, device) -> dict:
    """Each parameter's distance from its first value, by name."""
    return {n: float(torch.linalg.vector_norm(params[n].detach() - t))
            for group in initial_groups(cfg, seed, device)
            for n, t in group.items()}


def _block(x, p, cfg):
    w = weights.dims(cfg)
    eps, theta = float(cfg["rms_norm_eps"]), float(cfg["rope_theta"])
    t = x.shape[0]
    h = rms(x, p["ln1"], eps)
    q = rope(rms((h @ p["wq"]).view(t, w["h"], w["dh"]), p["q_norm"], eps),
             theta)
    k = rope(rms((h @ p["wk"]).view(t, w["hkv"], w["dh"]), p["k_norm"],
                 eps), theta)
    v = (h @ p["wv"]).view(t, w["hkv"], w["dh"])
    x = x + attention(q, k, v).reshape(t, -1) @ p["wo"]
    h = rms(x, p["ln2"], eps)
    return x + (F.silu(h @ p["wg"]) * (h @ p["wu"])) @ p["wd"]


def loss(params: dict, tokens: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Mean next-token cross-entropy of rows ``tokens`` (b, T + 1)."""
    lw = [{n: params[f"L{li}.{n}"] for n, _, _ in weights.layer_shapes(cfg)}
          for li in range(weights.dims(cfg)["layers"])]
    head = params["embed" if weights.tied(cfg) else "head"]
    total = 0.0
    for row in tokens:
        x = params["embed"][row[:-1]]
        for p in lw:
            x = checkpoint(_block, x, p, cfg, use_reentrant=False)
        x = rms(x, params["ln_f"], float(cfg["rms_norm_eps"]))
        total = total + F.cross_entropy(x @ head.T, row[1:])
    return total / tokens.shape[0]


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def run(cfg: dict, mix: dict, seed: int, device, steps: int = 3,
        tf32: bool = False, half_batch: bool = False) -> dict:
    """``steps`` steps from the seed's first values on its first batches:
    ``losses``, ``grad1`` {name: norm} and ``change`` {name: norm}."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        return _run(cfg, mix, seed, device, steps, half_batch)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def _run(cfg, mix, seed, device, steps, half_batch):
    t = cfg["train"]
    opt = t["adamw"]
    b1, b2 = float(opt["b1"]), float(opt["b2"])
    params = {n: v.detach().requires_grad_(True)
              for n, v in initial(cfg, seed, device).items()}
    m = {n: torch.zeros_like(v) for n, v in params.items()}
    v2 = {n: torch.zeros_like(v) for n, v in params.items()}
    batches = gen.TrainBatches(mix, cfg["vocab_size"], seed)
    mbs = int(mix["microbatches"])
    losses, grad1 = [], {}
    for s in range(steps):
        rows = torch.as_tensor(batches.batch(s), device=device).long()
        if half_batch:
            rows = rows[: rows.shape[0] // 2]
        step_loss = 0.0
        for mb in rows.chunk(min(mbs, rows.shape[0])):
            lmb = loss(params, mb, cfg) / min(mbs, rows.shape[0])
            lmb.backward()
            step_loss += float(lmb.detach())
        losses.append(step_loss)
        with torch.no_grad():
            g = {n: p.grad for n, p in params.items()}
            norm = torch.sqrt(sum(torch.sum(x * x) for x in g.values()))
            scale = torch.clamp(float(t["clip_norm"]) /
                                torch.clamp(norm, min=1e-12), max=1.0)
            for x in g.values():
                x.mul_(scale)
            if s == 0:
                grad1 = {n: float(torch.linalg.vector_norm(x))
                         for n, x in g.items()}
            count = _f32(float(s + 1))
            bc1 = float(1 - _f32(b1) ** count)
            bc2 = float(1 - _f32(b2) ** count)
            for n, p in params.items():
                m[n].mul_(b1).add_(g[n], alpha=1 - b1)
                v2[n].mul_(b2).addcmul_(g[n], g[n], value=1 - b2)
                upd = (m[n] / bc1) / ((v2[n] / bc2).sqrt() + float(opt["eps"]))
                p.sub_(float(opt["lr"]) * (upd + float(opt["weight_decay"]) * p))
                p.grad = None
    del m, v2
    with torch.no_grad():
        change = changes(params, cfg, seed, device)
    return {"losses": losses, "grad1": grad1, "change": change}
