"""Feed-forward layers at tensor-parallel size 1 — the counterparts of
``repro.models.mlp``: the dense MLP (``mlp_apply``: the GLU forms
swiglu and geglu, the plain activations relu2 and gelu) and the MoE
layer (``moe_apply``: top-k routing with the reference's capacity
drops, the expert products over every expert, a fused shared expert).

At tp = 1 the reference's MoE takes its ``_moe_einsum`` branch with one
rank owning every expert: the router runs on all tokens, each
(token, choice) pair gets a slot in its expert's capacity-bounded
buffer in token-major order, pairs past the capacity are dropped, and
the experts' outputs are gathered back and weighted by the gates.
Which pairs are dropped depends on every token routed together, so a
token's output depends on the batch it shares a call with whenever
the capacity bites.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import act_fn


def is_glu(act: str) -> bool:
    return act in ("swiglu", "geglu")


def _glu_act(act: str):
    """The gate activation of a GLU: silu for swiglu, gelu otherwise (the
    reference's ``_glu_act``, which the MoE experts always use)."""
    return act_fn("silu" if act == "swiglu" else "gelu")


def mlp_apply(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """x (..., d) in the compute dtype -> (..., d): ``(act(x @ wg) *
    (x @ wu)) @ wd`` for a GLU, ``act(x @ wu) @ wd`` otherwise.  geglu's
    gelu is the tanh approximation, as ``jax.nn.gelu``'s default."""
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
    """Top-k routing of tokens xt (n, d): (gates (n, k) f32, experts
    (n, k) int64).  Padded experts get logit -1e30 (zero mass); the
    softmax is f32; top-k breaks ties toward the lowest expert index, as
    ``jax.lax.top_k`` does (a stable descending sort); the k gates are
    renormalised to sum one.  The reference's auxiliary loss is not
    computed: ``moe_apply`` discards it."""
    m = cfg.moe
    logits = (xt @ router_w.to(xt.dtype)).float()
    if m.padded_experts and m.padded_experts > m.num_experts:
        pad = torch.arange(logits.shape[-1],
                           device=logits.device) >= m.num_experts
        logits = logits.masked_fill(pad, -1e30)
    gates_all = torch.softmax(logits, dim=-1)
    gate_k, idx_k = torch.sort(gates_all, dim=-1, descending=True,
                               stable=True)
    gate_k, idx_k = gate_k[:, :m.top_k], idx_k[:, :m.top_k]
    gate_k = gate_k / gate_k.sum(-1, keepdim=True).clamp_min(1e-9)
    return gate_k, idx_k


def positions_in_expert(idx_k: torch.Tensor, n_experts: int) -> torch.Tensor:
    """The slot of each (token, choice) pair in its expert's buffer,
    counted in flattened (token-major, then choice) order: (n * k,)."""
    flat = idx_k.reshape(-1)
    pos = F.one_hot(flat, n_experts).cumsum(0) - 1            # (nk, E)
    return pos.gather(1, flat[:, None])[:, 0]


def expert_ffn(wu, wg, wd, xb: torch.Tensor, act: str) -> torch.Tensor:
    """xb (E, C, d) -> (E, C, d): every expert's GLU over its buffer, one
    batched product per weight, empty experts included."""
    cd = xb.dtype
    u = torch.bmm(xb, wu.to(cd))
    g = _glu_act(act)(torch.bmm(xb, wg.to(cd)))
    return torch.bmm(g * u, wd.to(cd))


def moe_apply(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """x (b, t, d) in the compute dtype -> (b, t, d): the reference's
    ``moe_apply`` at tp = 1, where it takes the ``_moe_einsum`` branch
    whatever its ``moe_dispatch`` (the all-to-all dispatch exchanges
    tokens between tensor-parallel ranks and arrives with TP serving,
    ROADMAP A7).  Capacity ``int(n k cf / E) + 1`` slots per expert for
    n = b t tokens; pairs past it are dropped (they add zeros at the
    last slot and gather nothing); the kept outputs are weighted by the
    gates in the compute dtype and summed over the k choices; the shared
    expert, if any, is added last."""
    m = cfg.moe
    cd = x.dtype
    ep = m.experts_padded(1)
    b, t, d = x.shape
    n = b * t
    xt = x.reshape(n, d)
    gate_k, idx_k = route(p["router"], xt, cfg)
    cap = int(n * m.top_k * m.capacity_factor / ep) + 1

    flat_e = idx_k.reshape(-1)                                # (n k,)
    pos = positions_in_expert(idx_k, ep)
    keep = (pos < cap)[:, None]
    lp = pos.clamp(0, cap - 1)
    xtk = xt.repeat_interleave(m.top_k, dim=0)                # (n k, d)
    buf = torch.zeros((ep, cap, d), dtype=cd, device=x.device)
    buf.index_put_((flat_e, lp), torch.where(keep, xtk, 0),
                   accumulate=True)
    yb = expert_ffn(p["wu"], p["wg"], p["wd"], buf, cfg.act)
    gathered = torch.where(keep, yb[flat_e, lp], 0)
    w = gate_k.reshape(-1)[:, None].to(cd)
    out = (gathered * w).reshape(n, m.top_k, d).sum(1).reshape(b, t, d)
    if m.shared_ff:
        sh = p["shared"]
        u = x @ sh["wu"].to(cd)
        g = _glu_act(cfg.act)(x @ sh["wg"].to(cd))
        out = out + (g * u) @ sh["wd"].to(cd)
    return out
