"""AdamW with the reference's two state layouts, at data-parallel size 1.

The counterpart of ``repro.train.optimizer``:

  zero=0  m/v mirror each parameter (plus an f32 master copy when the
          parameters are bf16);
  zero=1  m/v/master as one flat f32 chunk per parameter — at dp = 1 the
          chunk is the whole parameter, so the reduce-scatter and the
          all-gather of the reference are identities.  Multi-process
          ZeRO arrives with ROADMAP A5/A6.

Unlike the reference's pure function, ``adamw_update`` updates the
parameters and the state IN PLACE (it returns the same objects): at
full width a second copy of 2.5 B f32 parameters would not fit beside
the optimizer state.  The bias corrections ``1 - b ** count`` are
computed in f32, as the reference computes them.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    zero: int = 0               # 0 | 1


def adamw_init(params: Any, ctx, opt_cfg: AdamWConfig) -> dict:
    del ctx                      # dp = 1: every chunk is the whole leaf
    f32 = torch.float32
    if opt_cfg.zero == 0:
        st = {"m": tree_map(lambda p: torch.zeros(p.shape, dtype=f32,
                                                  device=p.device), params),
              "v": tree_map(lambda p: torch.zeros(p.shape, dtype=f32,
                                                  device=p.device), params),
              "count": 0}
        ps = leaves(params)
        if ps and ps[0].dtype == torch.bfloat16:
            st["master"] = tree_map(lambda p: p.detach().float(), params)
        return st
    if opt_cfg.zero != 1:
        raise ValueError(f"zero must be 0 or 1, got {opt_cfg.zero}")
    flat = lambda p: torch.zeros(p.numel(), dtype=f32, device=p.device)
    return {"m": tree_map(flat, params), "v": tree_map(flat, params),
            "master": tree_map(lambda p: p.detach().float().reshape(-1)
                               .clone(), params),
            "count": 0}


def _bias_correction(b: float, count: int) -> float:
    f32 = torch.float32
    return float(1 - torch.tensor(b, dtype=f32) ** torch.tensor(
        float(count), dtype=f32))


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: dict, ctx,
                 opt_cfg: AdamWConfig):
    """One AdamW step on ``params`` with ``grads`` (same tree), in place.
    Returns ``(params, state)``."""
    del ctx
    cnt = state["count"] + 1
    b1, b2, eps = opt_cfg.b1, opt_cfg.b2, opt_cfg.eps
    bc1, bc2 = _bias_correction(b1, cnt), _bias_correction(b2, cnt)
    masters = leaves(state["master"]) if "master" in state \
        else [None] * len(leaves(params))
    for p, g, m, v, master in zip(leaves(params), leaves(grads),
                                  leaves(state["m"]), leaves(state["v"]),
                                  masters):
        gf = g.float()
        if opt_cfg.zero == 1:
            gf = gf.reshape(-1)
        m.mul_(b1).add_(gf, alpha=1 - b1)
        v.mul_(b2).addcmul_(gf, gf, value=1 - b2)
        base = master if master is not None else p
        denom = (v / bc2).sqrt_().add_(eps)
        step = (m / bc1).div_(denom).add_(base, alpha=opt_cfg.weight_decay)
        step.mul_(opt_cfg.lr)
        if master is None:
            p.sub_(step)
        else:
            master.sub_(step)
            p.copy_(master.view(p.shape))
    state["count"] = cnt
    return params, state
