"""JAX's threefry2x32 key derivation and categorical draw, bit for bit.

The serving sampler keys every draw as
``fold_in(fold_in(PRNGKey(seed), rid), position)`` and draws with
``jax.random.categorical`` (argmax of logits plus Gumbel noise).  To
give the reference's token streams for sampled requests, the port
reproduces those functions exactly as JAX computes them with
``jax_threefry_partitionable=True`` (the default of current JAX):

  * ``PRNGKey(seed)`` is the word pair ``(seed >> 32, seed & 0xFFFFFFFF)``
    of a 32-bit seed, i.e. ``(0, seed)``;
  * ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))``;
  * the 32 random bits at flat index ``i`` of a draw of shape ``(k,)``
    are ``x0 ^ x1`` for ``(x0, x1) = threefry2x32(key, (0, i))``;
  * ``uniform`` puts the top 23 bits in the mantissa of a float in
    [1, 2), subtracts 1 and maps onto ``[tiny, 1)``; Gumbel noise is
    ``-log(-log(u))``; ``categorical`` is the first argmax of
    ``logits + gumbel``.

Words are uint32 values held in int64 tensors (torch's uint32 support
is thin); every operation masks back to 32 bits.  All functions are
vectorised over a leading batch of keys and run on any device.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_F32_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """20-round Threefry-2x32 of counter words (x0, x1) under key
    (k0, k1); all int64 tensors holding uint32 values, broadcast."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def prng_key(seed: torch.Tensor):
    """``jax.random.PRNGKey`` of int32 seeds -> key words (k0, k1)."""
    seed = seed.long()
    return torch.zeros_like(seed), seed & _M32


def fold_in(key, data: torch.Tensor):
    """``jax.random.fold_in`` of int32 ``data`` into ``key``."""
    k0, k1 = key
    d = data.long() & _M32
    return threefry2x32(k0, k1, torch.zeros_like(d), d)


def random_bits(key, k: int) -> torch.Tensor:
    """32 random bits per element of a ``(..., k)`` draw, one key per
    leading row."""
    k0, k1 = (w[..., None] for w in key)
    lo = torch.arange(k, dtype=torch.int64, device=k0.device)
    x0, x1 = threefry2x32(k0, k1, torch.zeros_like(lo), lo)
    return x0 ^ x1


def uniform(key, k: int) -> torch.Tensor:
    """``jax.random.uniform(key, (k,), minval=tiny, maxval=1)`` in f32."""
    bits = random_bits(key, k)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    tiny = torch.tensor(_F32_TINY, dtype=torch.float32, device=bits.device)
    return torch.maximum(tiny, floats * (1.0 - tiny) + tiny)


def gumbel(key, k: int) -> torch.Tensor:
    return -torch.log(-torch.log(uniform(key, k)))


def categorical(key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` row by row: the first
    argmax of ``logits + gumbel`` over the last axis."""
    noise = gumbel(key, logits.shape[-1])
    return torch.argmax(noise + logits.float(), dim=-1)
