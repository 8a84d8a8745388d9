"""AdamW with the reference's two state layouts, on the stacked DP team.

The counterpart of ``repro.train.optimizer``:

  zero=0  m/v mirror each parameter (plus an f32 master copy when the
          parameters are bf16), held once: every DP replica of the
          reference holds the same copy;
  zero=1  ZeRO-1: per-leaf flat chunking over DP.  Each leaf of the
          reference's tree (one per stacked block weight,
          ``tree.ref_groups``) is padded and cut into ``dp`` chunks of
          ``c``; ``m``, ``v`` and the f32 ``master`` hold every PE's own
          chunk, stacked ``(dp, c)``.  The gradient rows' chunks are
          reduce-scattered through ``ctx.dp_comm.psum_scatter`` (each PE
          keeps its chunk's sum, divided by dp), Adam updates the owned
          chunks, and the new masters are all-gathered back through
          ``ctx.dp_comm.all_gather``: the communicator is the optimizer's
          wire.  A padded chunk's tail stays 0 (its gradient is 0).

At tp > 1 (the training layout, every leaf stacked per PE) zero=0 is
elementwise on the PE-stacked tensors; zero=1 chunks each PE's LOCAL
leaf over DP, as each reference device chunks its shard: ``m``, ``v``
and ``master`` are ``(dp, tp, c)`` (``(dp, c)`` at tp = 1), the
reduce-scatter and the all-gather run through ``dp_comm`` with the PE
axis carried along.

``adamw_update`` takes the gradients stacked over the replicas, in the
reference's layout (``grad.grad_rows``): zero=0 reads row 0 (the rows
are reduced and equal), zero=1 every row (each replica's own gradient).
Unlike the reference's pure function, it updates the parameters and the
state IN PLACE (it returns the same objects): at full width a second
copy of 2.5 B f32 parameters would not fit beside the optimizer state.
The bias corrections ``1 - b ** count`` are computed in f32, as the
reference computes them.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.tree import leaves, ref_groups, ref_tree, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    zero: int = 0               # 0 | 1


def _parts(group) -> list:
    return group if isinstance(group, list) else [group]


def _chunk(flat: torch.Tensor, dp: int) -> torch.Tensor:
    """Pad a stacked flat ``(n, numel)`` to ``(n, dp, c)``: each row's DP
    chunks (``_chunk`` of the reference, one row per PE)."""
    c = -(-flat.shape[1] // dp)
    return F.pad(flat, (0, dp * c - flat.shape[1])).reshape(
        flat.shape[0], dp, c)


def _flat(group, tp: int) -> torch.Tensor:
    """A reference leaf's per-PE flat view ``(tp, numel)``: its per-layer
    tensors' PE rows concatenated (layer-major, as the reference's
    stacked local leaf)."""
    return torch.cat([p.detach().float().reshape(tp, -1)
                      for p in _parts(group)], dim=1)


def _grad_flat(g: torch.Tensor, group, tp: int) -> torch.Tensor:
    """The gradient rows of a reference leaf, ``(dp, [L,] [tp,] ...)``,
    as ``(dp, tp, numel)`` per PE, in ``_flat``'s order."""
    if tp > 1 and isinstance(group, list):
        g = g.movedim(2, 1)
    return g.float().reshape(g.shape[0], tp, -1)


def adamw_init(params: Any, ctx, opt_cfg: AdamWConfig) -> dict:
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
    dp, tp = ctx.dp_size, ctx.tp_size
    lead = (dp, tp) if tp > 1 else (dp,)

    def zeros(g):
        t = _parts(g)[0]
        c = -(-sum(p.numel() for p in _parts(g)) // (dp * tp))
        return torch.zeros(lead + (c,), dtype=f32, device=t.device)

    def mine(g):
        # (tp, dp, c): PE t's leaf in dp chunks; device (r, t) owns chunk r
        ch = _chunk(_flat(g, tp), dp)
        return ch.transpose(0, 1).reshape(lead + (-1,)).contiguous()

    return {"m": ref_tree(params, zeros), "v": ref_tree(params, zeros),
            "master": ref_tree(params, mine), "count": 0}


def _bias_correction(b: float, count: int) -> float:
    f32 = torch.float32
    return float(1 - torch.tensor(b, dtype=f32) ** torch.tensor(
        float(count), dtype=f32))


def _adam_(m, v, g, base, b1, b2, bc1, bc2, opt_cfg) -> torch.Tensor:
    """m, v updated in place with ``g``; returns the step on ``base``."""
    m.mul_(b1).add_(g, alpha=1 - b1)
    v.mul_(b2).addcmul_(g, g, value=1 - b2)
    denom = (v / bc2).sqrt_().add_(opt_cfg.eps)
    step = (m / bc1).div_(denom).add_(base, alpha=opt_cfg.weight_decay)
    return step.mul_(opt_cfg.lr)


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: dict, ctx,
                 opt_cfg: AdamWConfig):
    """One AdamW step on ``params`` with the stacked ``grads`` (the
    reference's layout, ``(dp, ...)``), in place.  Returns ``(params,
    state)``."""
    cnt = state["count"] + 1
    b1, b2 = opt_cfg.b1, opt_cfg.b2
    bc1, bc2 = _bias_correction(b1, cnt), _bias_correction(b2, cnt)
    groups, gl = ref_groups(params), leaves(grads)
    if opt_cfg.zero == 0:
        mg, vg = ref_groups(state["m"]), ref_groups(state["v"])
        mag = ref_groups(state["master"]) if "master" in state \
            else [None] * len(groups)
        for group, g, ms, vs, mas in zip(groups, gl, mg, vg, mag):
            g0 = g[0]
            rows = list(g0) if isinstance(group, list) else [g0]
            for li, (p, m, v) in enumerate(zip(_parts(group), _parts(ms),
                                               _parts(vs))):
                master = None if mas is None else _parts(mas)[li]
                base = master if master is not None else p
                step = _adam_(m, v, rows[li].float(), base, b1, b2, bc1,
                              bc2, opt_cfg)
                if master is None:
                    p.sub_(step)
                else:
                    master.sub_(step)
                    p.copy_(master.view(p.shape))
        state["count"] = cnt
        return params, state

    # ---------------- zero-1 ----------------
    dp, tp, comm = ctx.dp_size, ctx.tp_size, ctx.dp_comm
    for group, g, m, v, master in zip(groups, gl, leaves(state["m"]),
                                      leaves(state["v"]),
                                      leaves(state["master"])):
        gf = _grad_flat(g, group, tp)                          # (dp, tp, n)
        gch = _chunk(gf.reshape(dp * tp, -1), dp).view(dp, tp, dp, -1)
        if dp > 1:
            gmine = comm.psum_scatter(gch, axis=1).reshape(dp, tp, -1) / dp
        else:
            gmine = gch[:, :, 0]
        mst = master.view(dp, tp, -1)
        mst.sub_(_adam_(m.view(dp, tp, -1), v.view(dp, tp, -1), gmine, mst,
                        b1, b2, bc1, bc2, opt_cfg))
        full = comm.all_gather(mst, axis=1, tiled=True)[0] if dp > 1 \
            else mst[0]                                        # (tp, dp c)
        off = 0
        for p in _parts(group):
            n = p.numel() // tp
            p.copy_(full[:, off:off + n].reshape(p.shape))
            off += n
    state["count"] = cnt
    return params, state
