"""The one traffic generator: it reads a mix's parameters
(``traffic/<mix>.json``) and the seed, and gives the cell's inputs.

Every draw comes from a numpy ``SeedSequence`` keyed by ``(seed, what,
index)``, so the i-th request or the s-th batch is the same whatever was
drawn before it (prefix-stable) and the same seed gives the same inputs.

Lengths are stratified: each block of ``block`` consecutive requests
holds the same ``block`` quantiles of the length distribution, in an
order the seed shuffles, and each aligned run of ``strata`` requests in
it holds one quantile of each of ``strata`` equal strata.  Every seed
therefore serves the same sizes in another order, and neither a
window's mix of lengths nor the mix of the requests in flight together
changes much with the seed.
"""
from __future__ import annotations

import math

import numpy as np

SEED_MOD = 1 << 63


def rng(seed: int, *key: int) -> np.random.Generator:
    """The generator of one draw, keyed by the run's seed and ``key``."""
    return np.random.default_rng([int(seed) % SEED_MOD, *map(int, key)])


def quantiles(dist: dict, n: int) -> np.ndarray:
    """``n`` stratified lengths of ``dist`` (the midpoints of ``n`` equal
    probability bins), as ints.  ``{"dist": "loguniform", "lo", "hi"}``
    or ``{"dist": "uniform", "lo", "hi"}``, both ends included."""
    lo, hi = float(dist["lo"]), float(dist["hi"])
    u = (np.arange(n) + 0.5) / n
    if dist["dist"] == "loguniform":
        x = np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    elif dist["dist"] == "uniform":
        x = lo + u * (hi - lo)
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


def stratified_order(r: np.random.Generator, block: int,
                     strata: int) -> np.ndarray:
    """A seeded order of the quantile indices ``0 .. block - 1`` in which
    each aligned run of ``strata`` entries holds one index of each of the
    ``strata`` equal strata (``strata`` 1: any order)."""
    per, rest = divmod(block, strata)
    if rest:
        raise ValueError(f"block {block} is not a multiple of strata "
                         f"{strata}")
    pick = np.stack([o * per + r.permutation(per) for o in range(strata)], 1)
    return np.concatenate([r.permutation(row) for row in pick])


class ServeStream:
    """Requests of a serving mix: ``request(i)`` -> (prompt ids int32,
    tokens to generate).  Ids are uniform over ``vocab``."""

    PROMPT, OUTPUT, IDS = 0, 1, 2

    def __init__(self, mix: dict, vocab: int, seed: int):
        self.mix, self.vocab, self.seed = mix, int(vocab), int(seed)
        self.block = int(mix.get("block", 64))
        self.strata = int(mix.get("strata", 1))
        self._p = quantiles(mix["prompt_tokens"], self.block)
        self._o = quantiles(mix["output_tokens"], self.block)
        self._perm: dict = {}

    def _block(self, b: int):
        if b not in self._perm:
            self._perm[b] = tuple(
                stratified_order(rng(self.seed, what, b), self.block,
                                 self.strata)
                for what in (self.PROMPT, self.OUTPUT))
        return self._perm[b]

    def lengths(self, i: int) -> tuple[int, int]:
        b, j = divmod(int(i), self.block)
        pp, po = self._block(b)
        return int(self._p[pp[j]]), int(self._o[po[j]])

    def request(self, i: int) -> tuple[np.ndarray, int]:
        n_prompt, n_out = self.lengths(i)
        ids = rng(self.seed, self.IDS, i).integers(
            0, self.vocab, size=n_prompt, dtype=np.int64).astype(np.int32)
        return ids, n_out


class TrainBatches:
    """Batches of a training mix: ``batch(s)`` -> tokens (rows, seq + 1)
    int32, uniform over ``vocab``; every row of every step differs."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        self.rows, self.seq = int(mix["rows"]), int(mix["seq"])
        self.vocab, self.seed = int(vocab), int(seed)

    def batch(self, step: int) -> np.ndarray:
        return rng(self.seed, 3, step).integers(
            0, self.vocab, size=(self.rows, self.seq + 1),
            dtype=np.int64).astype(np.int32)


class RmaPlan:
    """The operation stream of an RMA mix: ``ops[i % len(ops)]`` is the
    i-th operation, a ``quiet`` after every ``quiet_every``; round ``r``
    puts pattern ``pattern(r, k)``; ``sampled(r)`` says whether the
    check keeps round ``r``'s results (about one round in
    ``sample_every``, drawn from the seed)."""

    def __init__(self, mix: dict, seed: int):
        self.mix, self.seed = mix, int(seed)
        self.ops = list(mix["ops"])
        self.quiet_every = int(mix["quiet_every"])
        self.patterns = int(mix["patterns"])
        self.sample_every = int(mix["sample_every"])
        self._offset = int(rng(seed, 4).integers(0, self.sample_every))

    def pattern(self, r: int, k: int) -> int:
        return (r + k) % self.patterns

    def sampled(self, r: int) -> bool:
        return r % self.sample_every == self._offset
