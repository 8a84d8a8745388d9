"""Shared building blocks: initializer, RMS and layer norms, RoPE,
activations.

The counterparts of ``repro.models.common``.  Norms and rotations
compute in f32 and cast back to the input dtype, as the JAX functions
do.

The stacked TP layout's per-PE arithmetic is here too: ``tp_mm``, each
PE's product with its own weight (one batched matmul over the PE axis),
``pe_mm``, that product at tp > 1 and the plain one at tp = 1, and
``pe_vec``, a per-PE weight (tp, *s) shaped to broadcast against
activations (tp, ..., *s).  The norms take a scale (and bias) of
either form.
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


def tp_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-rank product: x (tp, ..., d) @ w (tp, d, n) -> (tp, ..., n), one
    batched matmul (the weights are never broadcast against ``x``)."""
    tp, d, n = w.shape
    out = torch.bmm(x.reshape(tp, -1, d), w.to(x.dtype))
    return out.reshape(x.shape[:-1] + (n,))


def pe_mm(x: torch.Tensor, w: torch.Tensor, tp: int) -> torch.Tensor:
    """``x @ w`` in x's dtype; at tp > 1 each PE's own (``tp_mm``)."""
    return tp_mm(x, w) if tp > 1 else x @ w.to(x.dtype)


def _align(w: torch.Tensor, x: torch.Tensor, n: int) -> torch.Tensor:
    """``w`` whose last ``n`` dims match x's last ``n``, its leading dims
    aligned with x's leading dims (ones between)."""
    k = w.dim() - n
    return w.reshape(w.shape[:k] + (1,) * (x.dim() - w.dim()) + w.shape[k:])


def pe_vec(w: torch.Tensor, x: torch.Tensor, tp: int,
           n: int = 1) -> torch.Tensor:
    """A weight of ``n`` dims (at tp > 1 stacked per PE, (tp, *s)) shaped
    to broadcast against x (..., *s) (at tp > 1 (tp, ..., *s))."""
    return _align(w, x, n) if tp > 1 else w


def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last dim; ``scale`` (d,), or (tp, d) in the TP
    layout against x (tp, ..., d): its leading axes align with x's."""
    scale = _align(scale, x, 1)
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


def layernorm(params: dict, x: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """Layer norm over the last dim with ``scale`` and ``bias`` (each (d,),
    or (tp, d) against x (tp, ..., d), as ``rmsnorm``'s scale); the
    variance is the biased one, as ``jnp.var``."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mu).mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * _align(params["scale"], x, 1).float() + \
        _align(params["bias"], x, 1).float()
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
