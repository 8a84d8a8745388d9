"""Roofline terms of a dry run on the H100 (counterpart of
``repro.launch.roofline``, whose constants are the TPU v5e's).

Terms (per-PE quantities over per-card rates):

  compute_s    = FLOPs_per_PE / PEAK_FLOPS[compute dtype]
  memory_s     = bytes_per_PE / HBM_BW
  collective_s = collective_bytes_per_PE / LINK_BW

The rates are **NVIDIA H100 SXM5 data-sheet values, not
measurements**: HBM3 3.35 TB/s; NVLink 4 450 GB/s in one direction (900
GB/s both ways); dense peaks of 989 TFLOP/s on the bf16 tensor cores and
67 TFLOP/s in f32 on the CUDA cores (the port keeps TF32 off, as its
trainer sets, so f32 products never reach the tensor cores).

Collective bytes are counted from the port's communicator calls
(``Communicator.payload_stats``: calls by op and per-PE payload), not
parsed from HLO as the reference's are: per call, the bytes one PE
receives, the collective's output buffer (the reference's convention) —
the payload for psum / pmax / all_to_all / pbroadcast, ``n`` payloads
for all_gather, ``1 / n`` of it for psum_scatter; a 1-PE communicator's
identity calls move nothing.
"""
from __future__ import annotations

from collections import Counter

import torch

HBM_BW = 3.35e12
LINK_BW = 450e9
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


def received_bytes(op: str, nbytes: int, n: int) -> int:
    """Bytes one PE receives in one ``op`` call with ``nbytes`` of
    per-PE payload on a team of ``n``."""
    if op == "all_gather":
        return nbytes * n
    if op == "psum_scatter":
        return nbytes // n
    return nbytes


def collective_bytes(comms) -> tuple[int, Counter]:
    """Per-PE received bytes of every call the communicators recorded,
    and per-op counts (``op`` calls and ``op + "_bytes"``)."""
    total = 0
    counts: Counter = Counter()
    for c in {id(c): c for c in comms if c is not None}.values():
        for (op, nbytes, _, algo), calls in c.payload_stats().items():
            if algo == "identity":
                continue
            b = received_bytes(op, nbytes, c.size) * calls
            total += b
            counts[op] += calls
            counts[op + "_bytes"] += b
    return total, counts


def terms(flops_dev: float, bytes_dev: float, coll_bytes_dev: float,
          dtype) -> dict:
    """The three roofline times (s) and the dominant one."""
    t = {"compute": flops_dev / PEAK_FLOPS[dtype],
         "memory": bytes_dev / HBM_BW,
         "collective": coll_bytes_dev / LINK_BW}
    return {"compute_s": t["compute"], "memory_s": t["memory"],
            "collective_s": t["collective"],
            "dominant": max(t.items(), key=lambda kv: kv[1])[0]}


def model_flops_train(cfg, tokens: int) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE)."""
    n = cfg.active_param_count()
    return 6.0 * n * tokens


def model_flops_decode(cfg, new_tokens: int, context: int) -> float:
    n = cfg.active_param_count()
    flops = 2.0 * n * new_tokens
    # attention against cache
    if not cfg.rwkv_head_dim and not (cfg.ssm_state and
                                      not cfg.shared_attn_every):
        eff_ctx = min(context, cfg.swa_window or context)
        n_att = cfg.n_layers if not cfg.shared_attn_every else \
            cfg.n_layers // cfg.shared_attn_every
        flops += (2.0 * n_att * cfg.n_heads * cfg.head_dim * 2 * eff_ctx
                  * new_tokens)
    return flops


def model_flops(cfg, kind: str, shape_info: dict) -> float:
    """The cell's model FLOPs: 6ND for training, 2ND for a prefill,
    ``model_flops_decode`` for a decode step (the reference's)."""
    gb, t = shape_info["global_batch"], shape_info["seq"]
    if kind == "train":
        return model_flops_train(cfg, gb * t)  # 6ND counts fwd+bwd
    if kind == "prefill":
        return 2.0 * cfg.active_param_count() * gb * t
    return model_flops_decode(cfg, gb, t)
