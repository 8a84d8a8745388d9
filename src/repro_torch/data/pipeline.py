"""Deterministic synthetic data: structured Zipf-ish token streams with
an injected learnable n-gram pattern, so a few hundred steps show a
clearly decreasing loss.

The counterpart of ``repro.data.pipeline.SyntheticLM``: the same numpy
generators in the same order, so a batch is byte for byte the
reference's, handed over as a torch tensor on the requested device.
Every replica derives its slice from (step, dp_rank) alone — the data
position is a pure function of the step counter.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve


@dataclasses.dataclass
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    pattern_order: int = 2   # learnable bigram structure

    def _trans(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        # sparse-ish bigram transition table: each token has 8 likely successors
        return rng.integers(0, self.vocab, size=(self.vocab, 8))

    def batch(self, step: int, dp_rank: int = 0, dp_size: int = 1,
              extra: int = 1, device=None) -> dict:
        """Local batch for this DP replica at ``step``: {'tokens': (b,
        seq_len + extra) int32} on ``device`` (None: the GPU)."""
        b_loc = self.global_batch // dp_size
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + dp_rank)
        succ = self._trans()
        t = self.seq_len + extra
        out = np.empty((b_loc, t), np.int32)
        cur = rng.integers(0, self.vocab, size=b_loc)
        out[:, 0] = cur
        for i in range(1, t):
            pick = rng.integers(0, 8, size=b_loc)
            noise = rng.random(b_loc) < 0.1
            nxt = succ[cur, pick]
            nxt = np.where(noise, rng.integers(0, self.vocab, size=b_loc), nxt)
            out[:, i] = nxt
            cur = nxt
        return {"tokens": torch.from_numpy(out).to(resolve(device))}
