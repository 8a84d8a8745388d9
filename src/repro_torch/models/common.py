"""Shared building blocks: initializer, RMS and layer norms, RoPE,
activations.

The counterparts of ``repro.models.common``.  Norms and rotations
compute in f32 and cast back to the input dtype, as the JAX functions
do.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def ninit(gen: torch.Generator, shape, scale: Optional[float] = None,
          dtype=torch.float32, device=None) -> torch.Tensor:
    """Normal init with scale ``1/sqrt(fan_in)`` (fan_in = ``shape[0]``
    for matrices), drawn in f32 from ``gen`` and cast to ``dtype``."""
    fan_in = shape[0] if len(shape) > 1 else 1
    scale = (1.0 / fan_in) ** 0.5 if scale is None else scale
    x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=device)
    return (x * scale).to(dtype)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last dim; ``scale`` (d,), or (tp, d) in the TP
    layout against x (tp, ..., d): its leading axes align with x's."""
    scale = scale.reshape(scale.shape[:-1] + (1,) * (x.dim() - scale.dim())
                          + scale.shape[-1:])
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


def layernorm(params: dict, x: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """Layer norm over the last dim with ``scale`` and ``bias``; the
    variance is the biased one, as ``jnp.var``."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mu).mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * params["scale"].float() + params["bias"].float()
    return out.to(x.dtype)


def norm_init(kind: str, d: int, dtype=torch.float32, device=None) -> dict:
    """``{"scale": ones}``, and for a layer norm ``"bias": zeros``."""
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layer":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def norm_apply(kind: str, params: dict, x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """The reference's ``norm_apply``: ``eps`` reaches only the RMS norm;
    a layer norm always takes its own 1e-5, as there."""
    if kind == "layer":
        return layernorm(params, x)
    return rmsnorm(params["scale"], x, eps)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Half-split rotation.  x: (..., t, h, dh); positions: (..., t)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, device=x.device)           # (dh/2,)
    ang = positions[..., :, None].float() * freqs            # (..., t, dh/2)
    cos = torch.cos(ang)[..., :, None, :]                    # (..., t, 1, dh/2)
    sin = torch.sin(ang)[..., :, None, :]
    xf1, xf2 = x[..., : dh // 2].float(), x[..., dh // 2:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    """``gelu`` (tanh approximation, as ``jax.nn.gelu``), ``silu`` and
    ``relu2`` (squared ReLU), by the reference's names."""
    return {"gelu": _gelu, "silu": F.silu,
            "relu2": lambda x: torch.square(F.relu(x))}[name]
