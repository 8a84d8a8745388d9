"""Dense SwiGLU feed-forward at tensor-parallel size 1 — the counterpart
of ``repro.models.mlp.mlp_apply`` for the archs the port serves."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def mlp_apply(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """x (..., d) in the compute dtype -> (..., d):
    ``(silu(x @ wg) * (x @ wu)) @ wd``."""
    if cfg.act != "swiglu":
        raise NotImplementedError(
            f"repro_torch mlp_apply runs swiglu; {cfg.act!r} arrives with "
            f"the archs that use it")
    u = x @ p["wu"].to(x.dtype)
    h = F.silu(x @ p["wg"].to(x.dtype)) * u
    return h @ p["wd"].to(x.dtype)
