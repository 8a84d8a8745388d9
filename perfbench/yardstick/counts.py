"""Operations and bytes of the work a cell asks for, reckoned from its
shapes alone, never from what a kernel happens to do: each input byte
read once, each output byte written once, and only the (query, key)
pairs the causal mask leaves.  A multiply-add is two operations.

``cfg`` is a configuration's published keys (``configs/<name>.json``).
"""
from __future__ import annotations

from . import peaks


def _w(cfg: dict) -> dict:
    d = int(cfg["hidden_size"])
    h = int(cfg["num_attention_heads"])
    return {"d": d, "h": h, "hkv": int(cfg["num_key_value_heads"]),
            "dh": int(cfg.get("head_dim", d // h)),
            "layers": int(cfg["num_hidden_layers"]),
            "v": int(cfg["vocab_size"]), "ff": int(cfg["intermediate_size"]),
            "e": int(cfg.get("num_experts", 0)),
            "k": int(cfg.get("num_experts_per_tok", 0)),
            "eff": int(cfg.get("moe_intermediate_size", 0))}


def layer_params(cfg: dict) -> int:
    """Matrix parameters one token passes through in one layer: the
    attention projections and the MLP, or the router and the experts it
    is routed to."""
    w = _w(cfg)
    attn = w["d"] * (w["h"] + 2 * w["hkv"]) * w["dh"] + \
        w["h"] * w["dh"] * w["d"]
    if w["e"]:
        return attn + w["d"] * w["e"] + w["k"] * 3 * w["d"] * w["eff"]
    return attn + 3 * w["d"] * w["ff"]


def causal_pairs(start: int, n: int) -> int:
    """(query, key) pairs of ``n`` queries at positions ``start ..
    start + n - 1``, each seeing every key up to its own position."""
    return n * start + n * (n + 1) // 2


def attention_flops(cfg: dict, pairs: int) -> float:
    """QK^T and PV over ``pairs`` (query, key) pairs, every head, one
    layer."""
    w = _w(cfg)
    return 4.0 * w["h"] * w["dh"] * pairs


def head_flops(cfg: dict) -> float:
    w = _w(cfg)
    return 2.0 * w["v"] * w["d"]


def forward_flops(cfg: dict, start: int, n: int) -> float:
    """Model operations of a forward over ``n`` tokens of one sequence at
    positions ``start ..``, every layer, the head not included."""
    w = _w(cfg)
    return w["layers"] * (2.0 * layer_params(cfg) * n +
                          attention_flops(cfg, causal_pairs(start, n)))


def paged_prefill_bound_s(cfg: dict, starts, n_toks, elem_bytes: int,
                          dtype: str) -> float:
    """The least time of one layer's paged prefill attention over a
    window's rows: each row's queries, the keys and values it can see,
    and its outputs, once; its causal pairs' operations."""
    w = _w(cfg)
    flops = nbytes = 0.0
    for s, n in zip(starts, n_toks):
        s, n = int(s), int(n)
        if n <= 0:
            continue
        flops += attention_flops(cfg, causal_pairs(s, n))
        nbytes += elem_bytes * w["dh"] * (2 * n * w["h"] + 2 * (s + n) * w["hkv"])
    return max(flops / peaks.FLOPS[dtype], nbytes / peaks.HBM_BYTES_S)


def flash_bound_s(batch: int, heads: int, kv_heads: int, t: int, d: int,
                  elem_bytes: int, flops_s: float) -> float:
    """The least time of one causal self-attention forward (T = S):
    q, k, v read and o and the row log-sum-exp (f32) written once."""
    flops = 4.0 * d * heads * batch * causal_pairs(0, t)
    nbytes = elem_bytes * batch * t * d * (2 * heads + 2 * kv_heads) + \
        4 * batch * heads * t
    return max(flops / flops_s, nbytes / peaks.HBM_BYTES_S)


def train_step_flops(cfg: dict, rows: int, seq: int) -> float:
    """6 N T over the matrix parameters (every layer's and the head's;
    the embedding is a lookup), plus the attention's forward and its
    backward (3x the forward) over the causal pairs; recompute not
    counted."""
    w = _w(cfg)
    n_params = w["layers"] * layer_params(cfg) + w["v"] * w["d"]
    attn = w["layers"] * attention_flops(cfg, causal_pairs(0, seq)) * rows
    return 6.0 * n_params * rows * seq + 3.0 * attn


def rma_bytes(n_pe: int, elems: int, elem_bytes: int) -> int:
    """Bytes one put or get moves at the least: each PE's payload read
    once and written once."""
    return 2 * n_pe * elems * elem_bytes
