"""Per-request batched sampling for the serving engine.

The counterpart of ``repro.serve.sampling``, two-phase: candidate
selection is the vocab's top-k with ties to the lowest index
(``models.embed.tp_sample_candidates``; at tp > 1 each vocab shard's
top-k, merged by ``ctx.tp_comm.top_k_merge``, the same list on every PE,
so the draw reads PE 0's), and the draw is a counter-based
stream per sequence keyed ``fold_in(fold_in(PRNGKey(seed), rid),
position)`` — reproduced bit for bit by ``serve.threefry`` — so no RNG
state threads through the engine and sampled token streams equal the
reference's.  Greedy rows (``temperature == 0``) take candidate 0.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.paged_attention import NEG_INF
from repro_torch.models import embed as emb
from repro_torch.parallel.ctx import tp_of

from . import threefry


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """One request's sampling policy.  ``temperature == 0`` is greedy
    (top_k/top_p are then ignored); ``top_k == 0`` disables the top-k
    cut; ``top_p == 1`` disables the nucleus cut."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")


GREEDY = SamplingParams()


def batch_state(reqs, max_batch: int, seed: int) -> dict:
    """Pack per-request :class:`SamplingParams` + RNG stream ids into
    host arrays; empty batch slots sample greedily (their tokens are
    discarded)."""
    st = {
        "temperature": np.zeros((max_batch,), np.float32),
        "top_k": np.zeros((max_batch,), np.int32),
        "top_p": np.ones((max_batch,), np.float32),
        "rid": np.zeros((max_batch,), np.int32),
        "seed": np.int32(seed),
    }
    for i, r in enumerate(reqs):
        sp = r.sampling
        st["temperature"][i] = sp.temperature
        st["top_k"][i] = sp.top_k
        st["top_p"][i] = sp.top_p
        st["rid"][i] = r.rid
    return st


def sample_from_candidates(vals: torch.Tensor, idxs: torch.Tensor,
                           state: dict, pos: torch.Tensor) -> torch.Tensor:
    """Draw one token per row from value-sorted candidates.

    vals/idxs: (b, k); ``state`` the ``batch_state`` arrays; ``pos``
    (b,) the absolute position of the token being GENERATED (the RNG
    counter).  Greedy rows take candidate 0."""
    dev = vals.device
    b, k = vals.shape
    temp = torch.as_tensor(state["temperature"], device=dev)
    greedy = temp <= 0.0
    t = torch.where(greedy, torch.ones_like(temp), temp.clamp_min(1e-6))
    logit = vals.float() / t[:, None]

    j = torch.arange(k, device=dev)[None, :]
    top_k = torch.as_tensor(state["top_k"], device=dev)[:, None]
    logit = torch.where((top_k > 0) & (j >= top_k),
                        torch.full_like(logit, NEG_INF), logit)

    # nucleus cut on the (descending) candidate probabilities: keep the
    # smallest prefix with mass >= top_p (candidate 0 always survives)
    p = torch.softmax(logit, dim=-1)
    mass_before = torch.cumsum(p, dim=-1) - p
    top_p = torch.as_tensor(state["top_p"], device=dev)[:, None]
    logit = torch.where(mass_before >= top_p,
                        torch.full_like(logit, NEG_INF), logit)

    seed = torch.full((b,), int(state["seed"]), dtype=torch.int64,
                      device=dev)
    rid = torch.as_tensor(state["rid"], device=dev)
    key = threefry.fold_in(threefry.fold_in(threefry.prng_key(seed), rid),
                           pos.to(device=dev, dtype=torch.int32))
    choice = threefry.categorical(key, logit)
    choice = torch.where(greedy, torch.zeros_like(choice), choice)
    return torch.gather(idxs, 1, choice[:, None])[:, 0]


def _candidates(logits, n_candidates, ctx):
    """The merged candidate lists; at tp > 1 PE 0's row of the stack
    (every PE holds the same lists after the merge)."""
    vals, idxs = emb.tp_sample_candidates(logits, n_candidates, ctx)
    if tp_of(ctx) > 1:
        return vals[0], idxs[0]
    return vals, idxs


def sample_tokens(logits: torch.Tensor, state: dict, pos: torch.Tensor,
                  n_candidates: int = 8, ctx=None) -> torch.Tensor:
    """Candidates then the per-sequence counter-RNG draw: (b, V) logits
    -> (b,) int32 tokens; at tp > 1 the shards' (tp, b, V/tp) logits."""
    vals, idxs = _candidates(logits, n_candidates, ctx)
    return sample_from_candidates(vals, idxs, state, pos)


def sample_window_tokens(logits: torch.Tensor, state: dict,
                         pos: torch.Tensor,
                         n_candidates: int = 8, ctx=None) -> torch.Tensor:
    """The window form of :func:`sample_tokens`, what speculative verify
    uses: one draw per (sequence, window row).  ``logits`` (b, C, V);
    ``pos`` (b, C) the absolute position of the token GENERATED at each
    row (the RNG counter).  Row ``(i, j)`` draws with the key a decode
    step at that position would use, ``fold_in(fold_in(PRNGKey(seed),
    rid), pos[i, j])``, so a verified window reproduces the sequential
    stream wherever the fed tokens match.  Returns (b, C) tokens (at
    tp > 1 from the shards' (tp, b, C, V/tp) logits)."""
    vals, idxs = _candidates(logits, n_candidates, ctx)
    b, c, k = vals.shape
    flat = {name: np.repeat(state[name], c)
            for name in ("temperature", "top_k", "top_p", "rid")}
    flat["seed"] = state["seed"]
    toks = sample_from_candidates(vals.reshape(b * c, k),
                                  idxs.reshape(b * c, k), flat,
                                  pos.reshape(b * c))
    return toks.reshape(b, c)
