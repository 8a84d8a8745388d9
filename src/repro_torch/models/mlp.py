"""Feed-forward layers — the counterparts of ``repro.models.mlp``: the
dense MLP (``mlp_apply``: the GLU forms swiglu and geglu, the plain
activations relu2 and gelu) and the MoE layer (``moe_apply``: top-k
routing with the reference's capacity drops, the expert products over
every expert, a fused shared expert).

The dense MLP also serves at tp > 1, Megatron column -> row parallel
with the weights stacked on the PE axis (``weights.shard_for_tp``):
``wu``/``wg`` split by columns, ``wd`` by rows, and the closing
``ctx.tp_comm.psum`` (the reference's ``sp_scatter`` with sequence
parallelism off).

The MoE layer routes every token on every rank (the router is
replicated): each (token, choice) pair gets a slot in its expert's
capacity-bounded buffer in token-major order, pairs past the capacity
are dropped, and the experts' outputs are gathered back and weighted by
the gates.  Which pairs are dropped depends on every token routed
together, so a token's output depends on the batch it shares a call
with whenever the capacity bites.  At tp = 1 one rank owns every
expert (the reference's ``_moe_einsum`` with ``e_loc = E``).  At tp > 1
the experts are split on their own axis, rank ``t`` owning ``E/tp`` of
them (``weights.shard_for_tp``), and ``ctx.moe_dispatch`` picks the
reference's route: ``"einsum"`` (``_moe_einsum``: each rank fills and
runs only its own experts' buffers, zeros elsewhere, and one psum sums
the ranks' partial outputs) or ``"alltoall"`` (``_moe_alltoall``: each
rank fills every expert's buffer, ``all_to_all`` sends each block to its
experts' owner, which runs them over the ``tp`` copies it receives, and
a second ``all_to_all`` brings the outputs home; no psum).  The shared
expert is column -> row parallel with a psum of its own, added after
the routed output, as the reference adds it.

Capacity is counted per serving replica: ``StackedExec`` folds R
replicas into the batch rows, but each of the reference's replicas (a
data-parallel rank) routes only its own rows, so ``moe_apply`` takes
``replicas`` and routes each replica's ``B * t`` tokens on their own.

Training differentiates the same code: the gradient flows back through
the buffer scatter (``index_put_`` with accumulation), the gather of
the experts' outputs, the gates and the router; a dropped pair
contributes zeros, so its gradient is zero, and a padded expert (logit
-1e30, never chosen) gets exactly zero gradient.  The reference's
Switch auxiliary loss is never added to its loss, so none is computed.
Capacity in training is counted over each microbatch of each DP replica
(the rows one reference device routes in one scan step), token-major.
At tp > 1 the router is stacked per PE like every leaf
(``weights.shard_for_tp``), and in training ``moe_apply(..., sp=True)``
takes the sequence-parallel routes of the reference (its docstring).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.parallel.ctx import sp_gather, sp_scatter, tp_of

from .attention import tp_mm
from .common import act_fn


def is_glu(act: str) -> bool:
    return act in ("swiglu", "geglu")


def _glu_act(act: str):
    """The gate activation of a GLU: silu for swiglu, gelu otherwise (the
    reference's ``_glu_act``, which the MoE experts always use)."""
    return act_fn("silu" if act == "swiglu" else "gelu")


def mlp_apply(p: dict, x: torch.Tensor, cfg, ctx=None,
              sp: bool = False) -> torch.Tensor:
    """x (..., d) in the compute dtype -> (..., d): ``(act(x @ wg) *
    (x @ wu)) @ wd`` for a GLU, ``act(x @ wu) @ wd`` otherwise.  geglu's
    gelu is the tanh approximation, as ``jax.nn.gelu``'s default.  At
    tp > 1, x (tp, ..., d) -> the psum of the ranks' partial outputs,
    (tp, ..., d); with ``sp`` (training) x is (tp, b, t/tp, d) sequence
    shards, gathered in by ``sp_gather`` and the partials
    reduce-scattered out by ``sp_scatter``, as the reference's."""
    if tp_of(ctx) > 1:
        if sp:
            x = sp_gather(x, ctx)
        u = tp_mm(x, p["wu"])
        h = (_glu_act(cfg.act)(tp_mm(x, p["wg"])) * u if is_glu(cfg.act)
             else act_fn(cfg.act)(u))
        out = tp_mm(h, p["wd"])
        return sp_scatter(out, ctx) if sp else ctx.tp_comm.psum(out)
    u = x @ p["wu"].to(x.dtype)
    if is_glu(cfg.act):
        h = _glu_act(cfg.act)(x @ p["wg"].to(x.dtype)) * u
    else:
        h = act_fn(cfg.act)(u)
    return h @ p["wd"].to(x.dtype)


# ----------------------------------------------------------------------
# MoE
# ----------------------------------------------------------------------
def moe_shapes(cfg) -> dict:
    """Parameter shapes of one MoE layer at tp = 1: the router (d, E),
    the experts' ``wu``/``wg`` (E, d, ff) and ``wd`` (E, ff, d), and,
    with ``shared_ff``, the fused shared expert.  E counts the padded
    experts (``experts_padded(1)``).  The router's entry is a (shape,
    init scale) pair: it is drawn with scale 0.02, as the reference's."""
    d, m = cfg.d_model, cfg.moe
    e, ff = m.experts_padded(1), m.expert_ff
    shapes = {"router": ((d, e), 0.02), "wu": (e, d, ff), "wg": (e, d, ff),
              "wd": (e, ff, d)}
    if m.shared_ff:
        shapes["shared"] = {"wu": (d, m.shared_ff), "wg": (d, m.shared_ff),
                            "wd": (m.shared_ff, d)}
    return shapes


def route(router_w: torch.Tensor, xt: torch.Tensor, cfg):
    """Top-k routing of tokens xt (..., n, d): (gates (..., n, k) f32,
    experts (..., n, k) int64).  Padded experts get logit -1e30 (zero
    mass); the softmax is f32; top-k breaks ties toward the lowest expert
    index, as ``jax.lax.top_k`` does (a stable descending sort); the k
    gates are renormalised to sum one.  The reference's auxiliary loss
    is not computed: ``moe_apply`` discards it."""
    m = cfg.moe
    logits = (xt @ router_w.to(xt.dtype)).float()
    if m.padded_experts and m.padded_experts > m.num_experts:
        pad = torch.arange(logits.shape[-1],
                           device=logits.device) >= m.num_experts
        logits = logits.masked_fill(pad, -1e30)
    gates_all = torch.softmax(logits, dim=-1)
    gate_k, idx_k = torch.sort(gates_all, dim=-1, descending=True,
                               stable=True)
    gate_k, idx_k = gate_k[..., :m.top_k], idx_k[..., :m.top_k]
    gate_k = gate_k / gate_k.sum(-1, keepdim=True).clamp_min(1e-9)
    return gate_k, idx_k


def positions_in_expert(idx_k: torch.Tensor, n_experts: int) -> torch.Tensor:
    """The slot of each (token, choice) pair of idx_k (..., n, k) in its
    expert's buffer, counted in flattened (token-major, then choice)
    order over the n tokens of each leading index: (..., n * k)."""
    flat = idx_k.flatten(-2)
    pos = F.one_hot(flat, n_experts).cumsum(-2) - 1           # (.., nk, E)
    return pos.gather(-1, flat[..., None])[..., 0]


def expert_ffn(wu, wg, wd, xb: torch.Tensor, act: str) -> torch.Tensor:
    """xb (E, C, d) -> (E, C, d): every expert's GLU over its buffer, one
    batched product per weight, empty experts included."""
    cd = xb.dtype
    u = torch.bmm(xb, wu.to(cd))
    g = _glu_act(act)(torch.bmm(xb, wg.to(cd)))
    return torch.bmm(g * u, wd.to(cd))


def moe_apply(p: dict, x: torch.Tensor, cfg, ctx=None,
              replicas: int = 1, sp: bool = False) -> torch.Tensor:
    """x (b, t, d) in the compute dtype -> (b, t, d): the reference's
    ``moe_apply`` with sequence parallelism off, as its serving engine
    calls it.  Capacity ``int(n k cf / E) + 1`` slots per expert for n =
    b t tokens; pairs past it are dropped (they add zeros at the last
    slot and gather nothing); the kept outputs are weighted by the gates
    in the compute dtype and summed over the k choices; the shared
    expert, if any, is added last.  At tp > 1, x (tp, R b, t, d) with
    the rows of ``replicas`` R replicas replica-major -> (tp, R b, t,
    d), each replica routed alone (n = b t), through
    ``ctx.moe_dispatch``.  With ``sp`` (training, one replica) x is (tp,
    b, t/tp, d) sequence shards: the einsum route gathers the sequence
    (``sp_gather``), routes all b t tokens on every rank, runs the local
    experts and reduce-scatters the partials (``sp_scatter``); the
    alltoall route routes each rank's own shard (capacity from its n =
    b t / tp tokens) and its output stays sharded, as the reference's
    ``_moe_alltoall``; the shared expert is column -> row parallel
    between ``sp_gather`` and ``sp_scatter``.  Every step is
    differentiable: the scatter into the expert buffers, the gather
    back, the gates and the router (a dropped pair's gradient is zero,
    a padded expert's too)."""
    m = cfg.moe
    if m.shared_ff and not is_glu(cfg.act):
        raise ValueError(f"the shared expert is a GLU; act {cfg.act!r} is "
                         f"not one")
    tp = tp_of(ctx)
    if tp > 1 and sp:
        if replicas != 1:
            raise ValueError("training routes one replica at a time")
        out = _moe_train_tp(p, x, cfg, ctx)
    elif tp > 1:
        out = _moe_tp(p, x, cfg, ctx, int(replicas))
    else:
        if replicas != 1:
            raise ValueError(f"{replicas} replicas need the stacked layout")
        b, t, d = x.shape
        out = _moe_routed(p, x.reshape(1, 1, b * t, d), cfg, 1, None)
        out = out.reshape(b, t, d)
    if m.shared_ff:
        out = out + mlp_apply(p["shared"], x, cfg, ctx, sp=sp)
    return out


def _moe_train_tp(p, x, cfg, ctx) -> torch.Tensor:
    """The routed experts in TP training: x (tp, b, t_loc, d) -> the same
    layout (``moe_apply``'s ``sp``)."""
    tp = ctx.tp_size
    if ctx.moe_dispatch == "alltoall":
        _, b, tl, d = x.shape
        out = _moe_routed(p, x.reshape(tp, 1, b * tl, d), cfg, tp, ctx,
                          alltoall=True)
        return out.reshape(x.shape)
    xf = sp_gather(x, ctx)                                # (tp, b, t, d)
    _, b, t, d = xf.shape
    out = _moe_routed(p, xf.reshape(tp, 1, b * t, d), cfg, tp, ctx)
    return sp_scatter(out.reshape(xf.shape), ctx)


def _moe_tp(p, x, cfg, ctx, replicas: int) -> torch.Tensor:
    """The routed experts at tp > 1: x (tp, R b, t, d) -> (tp, R b, t, d)
    through the dispatch ``ctx.moe_dispatch`` names."""
    tp, rows, t, d = x.shape
    if rows % replicas:
        raise ValueError(f"{rows} rows do not split into {replicas} "
                         f"replicas")
    xr = x.reshape(tp, replicas, rows // replicas * t, d)
    if ctx.moe_dispatch == "alltoall":
        out = _moe_routed(p, xr, cfg, tp, ctx, alltoall=True)
    else:
        out = ctx.tp_comm.psum(_moe_routed(p, xr, cfg, tp, ctx))
    return out.reshape(x.shape)


def _moe_routed(p, x, cfg, tp: int, ctx, alltoall: bool = False):
    """Route and run the experts of x (tp, R, n, d) — every PE's copy of
    each replica's n tokens — with the experts split over ``tp`` ranks
    (``p``'s ``wu``/``wg``/``wd`` (tp, E/tp, ...) at tp > 1, (E, ...) at
    tp = 1).  Returns (tp, R, n, d): under the einsum dispatch each
    rank's partial output (its own experts' pairs, zeros for the rest;
    the caller psums); under ``alltoall`` every rank's whole routed
    output, its buffers exchanged with the experts' owners by two
    ``all_to_all`` calls."""
    m = cfg.moe
    cd, dev = x.dtype, x.device
    ep = m.experts_padded(1)
    e_loc, k = ep // tp, m.top_k
    _, reps, n, d = x.shape
    # the router (d, E), or each PE's copy (tp, d, E) against x (tp, R, ..)
    router = p["router"] if tp == 1 else p["router"].unsqueeze(1)
    gate_k, idx_k = route(router, x, cfg)                 # (tp, R, n, k)
    cap = int(n * k * m.capacity_factor / ep) + 1
    flat_e = idx_k.reshape(tp, reps, n * k)
    pos = positions_in_expert(idx_k, ep)
    keep = pos < cap
    lp = pos.clamp(0, cap - 1)
    pe = torch.arange(tp, device=dev).view(tp, 1, 1).expand_as(flat_e)
    rep = torch.arange(reps, device=dev).view(1, reps, 1).expand_as(flat_e)
    xtk = x.repeat_interleave(k, dim=2)                   # (tp, R, n k, d)
    w = [p[name].reshape((ep,) + p[name].shape[-2:])      # (E, ..), a view
         for name in ("wu", "wg", "wd")]
    if alltoall:
        # every rank fills every expert's buffer; the block of experts
        # rank j owns goes to rank j, which runs them over the tp copies
        send = torch.zeros((tp, reps, ep, cap, d), dtype=cd, device=dev)
        send.index_put_((pe, rep, flat_e, lp),
                        torch.where(keep[..., None], xtk, 0), accumulate=True)
        send = send.view(tp, reps, tp, e_loc * cap, d).transpose(1, 2)
        recv = ctx.tp_comm.all_to_all(send.contiguous(), split_axis=0,
                                      concat_axis=0)  # (tp, src, R, ..)
        xb = recv.view(tp, tp, reps, e_loc, cap, d).permute(0, 3, 1, 2, 4, 5)
        yb = expert_ffn(*w, xb.reshape(ep, tp * reps * cap, d), cfg.act)
        back = yb.view(tp, e_loc, tp, reps, cap, d).permute(0, 2, 3, 1, 4, 5)
        ret = ctx.tp_comm.all_to_all(
            back.reshape(tp, tp, reps, e_loc * cap, d), split_axis=0,
            concat_axis=0)                            # (tp, owner, R, ..)
        ret = ret.view(tp, tp, reps, e_loc, cap, d).transpose(1, 2)
        yb = ret.reshape(tp, reps, ep, cap, d)
        gathered = torch.where(keep[..., None], yb[pe, rep, flat_e, lp], 0)
    else:
        # each rank fills and runs only its own experts' buffers
        e_lo = (torch.arange(tp, device=dev) * e_loc).view(tp, 1, 1)
        local = (flat_e >= e_lo) & (flat_e < e_lo + e_loc) & keep
        le = (flat_e - e_lo).clamp(0, e_loc - 1)
        buf = torch.zeros((tp, e_loc, reps, cap, d), dtype=cd, device=dev)
        buf.index_put_((pe, le, rep, lp),
                       torch.where(local[..., None], xtk, 0), accumulate=True)
        yb = expert_ffn(*w, buf.view(ep, reps * cap, d), cfg.act)
        yb = yb.view(tp, e_loc, reps, cap, d)
        gathered = torch.where(local[..., None], yb[pe, le, rep, lp], 0)
    wt = gate_k.reshape(tp, reps, n * k, 1).to(cd)
    return (gathered * wt).reshape(tp, reps, n, k, d).sum(3)
