"""Dense feed-forward at tensor-parallel size 1 — the counterpart of
``repro.models.mlp.mlp_apply``: the GLU forms (swiglu, geglu) and the
plain activations (relu2, gelu)."""
from __future__ import annotations

import torch

from .common import act_fn

_GLU = {"swiglu": "silu", "geglu": "gelu"}


def is_glu(act: str) -> bool:
    return act in _GLU


def mlp_apply(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """x (..., d) in the compute dtype -> (..., d): ``(act(x @ wg) *
    (x @ wu)) @ wd`` for a GLU, ``act(x @ wu) @ wd`` otherwise.  geglu's
    gelu is the tanh approximation, as ``jax.nn.gelu``'s default."""
    u = x @ p["wu"].to(x.dtype)
    if is_glu(cfg.act):
        h = act_fn(_GLU[cfg.act])(x @ p["wg"].to(x.dtype)) * u
    else:
        h = act_fn(cfg.act)(u)
    return h @ p["wd"].to(x.dtype)
