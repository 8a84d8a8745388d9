"""Seeded weights of a decoder, made on the device in the dtype they are
served or trained in: one ``torch.randn`` call a layer (every matrix and
norm scale of the layer cut from it), one for each vocabulary table.

The benchmark hands the same weights to both sides: the program gets
them stacked in its own layout (``stacked``), the reference draws each
layer again (``layer``), bit for bit the same, once the program's state
is gone.  Matrices are normal at ``1/sqrt(fan_in)`` (fan_in the input
width), the embedding normal at 0.02, every norm scale ``1 + 0.1``
normal, the router normal at 0.02.

Names are the ``x @ w`` orientation: ``wq`` (d, H dh), ``wk``/``wv`` (d,
Hkv dh), ``wo`` (H dh, d), ``wg``/``wu`` (d, ff), ``wd`` (ff, d); a MoE
layer's ``router`` (d, E) and experts ``wg``/``wu`` (E, d, ff), ``wd``
(E, ff, d); ``embed`` and ``head`` (V, d).
"""
from __future__ import annotations

import hashlib

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def stream_seed(seed: int, tag: str) -> int:
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def _randn(seed: int, tag: str, n: int, dtype, device) -> torch.Tensor:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, tag))
    return torch.randn(n, generator=g, dtype=dtype, device=device)


def dims(cfg: dict) -> dict:
    """The widths the weights take from a configuration's published
    keys."""
    d = int(cfg["hidden_size"])
    return {"d": d, "h": int(cfg["num_attention_heads"]),
            "hkv": int(cfg["num_key_value_heads"]),
            "dh": int(cfg.get("head_dim", d // cfg["num_attention_heads"])),
            "v": int(cfg["vocab_size"]), "layers": int(cfg["num_hidden_layers"]),
            "ff": int(cfg["intermediate_size"]),
            "experts": int(cfg.get("num_experts", 0)),
            "eff": int(cfg.get("moe_intermediate_size", 0))}


def layer_shapes(cfg: dict) -> list:
    """(name, shape, kind) of one layer's tensors, in the order they are
    cut from the layer's draw; kind ``norm``, ``router`` or a matrix's
    fan_in."""
    w = dims(cfg)
    d, h, hkv, dh = w["d"], w["h"], w["hkv"], w["dh"]
    out = [("ln1", (d,), "norm"), ("q_norm", (dh,), "norm"),
           ("k_norm", (dh,), "norm"), ("ln2", (d,), "norm"),
           ("wq", (d, h * dh), d), ("wk", (d, hkv * dh), d),
           ("wv", (d, hkv * dh), d), ("wo", (h * dh, d), h * dh)]
    if w["experts"]:
        e, ff = w["experts"], w["eff"]
        out += [("router", (d, e), "router"), ("wg", (e, d, ff), d),
                ("wu", (e, d, ff), d), ("wd", (e, ff, d), ff)]
    else:
        ff = w["ff"]
        out += [("wg", (d, ff), d), ("wu", (d, ff), d), ("wd", (ff, d), ff)]
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _shape_draw(flat: torch.Tensor, kind) -> torch.Tensor:
    if kind == "norm":
        return flat.mul_(0.1).add_(1.0)
    if kind == "router":
        return flat.mul_(0.02)
    return flat.mul_(float(kind) ** -0.5)


def layer(cfg: dict, seed: int, li: int, dtype, device) -> dict:
    """Layer ``li``'s tensors, name -> tensor (views of one draw)."""
    shapes = layer_shapes(cfg)
    flat = _randn(seed, f"layer{li}", sum(_numel(s) for _, s, _ in shapes),
                  dtype, device)
    out, off = {}, 0
    for name, shape, kind in shapes:
        n = _numel(shape)
        out[name] = _shape_draw(flat[off:off + n], kind).view(shape)
        off += n
    return out


def table(cfg: dict, seed: int, name: str, dtype, device) -> torch.Tensor:
    """``embed`` (normal at 0.02) or ``head`` (at ``1/sqrt(d)``), (V, d);
    ``ln_f`` the final norm's scale (d,)."""
    w = dims(cfg)
    if name == "ln_f":
        return _shape_draw(_randn(seed, name, w["d"], dtype, device), "norm")
    t = _randn(seed, name, w["v"] * w["d"], dtype, device)
    t.mul_(0.02 if name == "embed" else w["d"] ** -0.5)
    return t.view(w["v"], w["d"])


def tied(cfg: dict) -> bool:
    return bool(cfg.get("tie_word_embeddings", False))


def stacked(cfg: dict, seed: int, dtype, device) -> dict:
    """Every weight in the program's layout (``repro_torch.models.lm``):
    ``embed``/``head`` tables, ``ln_f``, and ``blocks`` of stacked (L,
    ...) leaves, filled layer by layer."""
    w = dims(cfg)
    n = w["layers"]
    shapes = layer_shapes(cfg)
    flat = {name: torch.empty((n,) + tuple(s), dtype=dtype, device=device)
            for name, s, _ in shapes}
    for li in range(n):
        for name, t in layer(cfg, seed, li, dtype, device).items():
            flat[name][li].copy_(t)
    attn = {"wq": flat["wq"], "wk": flat["wk"], "wv": flat["wv"],
            "wo": flat["wo"], "q_norm": {"scale": flat["q_norm"]},
            "k_norm": {"scale": flat["k_norm"]}}
    mlp_keys = ("router", "wg", "wu", "wd") if w["experts"] else \
        ("wg", "wu", "wd")
    params = {"embed": {"table": table(cfg, seed, "embed", dtype, device)},
              "ln_f": {"scale": table(cfg, seed, "ln_f", dtype, device)},
              "blocks": {"ln1": {"scale": flat["ln1"]}, "attn": attn,
                         "ln2": {"scale": flat["ln2"]},
                         "mlp": {k: flat[k] for k in mlp_keys}}}
    if not tied(cfg):
        params["head"] = {"table": table(cfg, seed, "head", dtype, device)}
    return params
