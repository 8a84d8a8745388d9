"""Seeded synthetic serving traffic: Poisson arrivals, mixed lengths.

The counterpart of ``repro.serve.traffic``: for the same
``TrafficConfig`` the trace is byte-identical to the reference's (both
draw from numpy ``RandomState`` streams per ``(seed, rid)``).

The generator is deliberately simple and fully determined by its seed —
the same trace drives the benchmark, the CLI and the parity suites, so
"identical token streams across backends" is a meaningful assertion.
Prompt/output lengths are drawn from a short/long mixture (the bimodal
shape real serving traffic has: chat turns vs document prompts).

Every request draws from its OWN RNG stream, seeded by ``(seed, rid)``:
request ``i`` is a pure function of the config and ``i``, never of
``n_requests``.  Traces are therefore PREFIX-STABLE — growing a
benchmark from 16 to 64 requests extends the trace instead of
reshuffling every prompt — which is what makes rows at different scales
comparable.  (The old generator drew all arrival gaps in one
``size=n_requests`` call before the per-request draws, so changing
``n_requests`` shifted the RNG stream under every request.)
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .sampling import SamplingParams
from .scheduler import Request

# stream-splitting constant for the SLO attribute draws: a separate
# per-request RNG so enabling classes/tenants never shifts the classic
# prompt/length draws
_SLO_STREAM = 0x510


def _slo_attrs(tcfg: "TrafficConfig", rid: int) -> tuple:
    """(priority, deadline, tenant) for request ``rid`` — drawn from
    the derived ``(seed ^ _SLO_STREAM, rid)`` stream, or the all-
    interactive defaults when the config requests no SLO traffic."""
    plain = (tcfg.interactive_frac >= 1.0 and tcfg.batch_frac <= 0.0
             and tcfg.n_tenants <= 1)
    if plain:
        return "interactive", tcfg.deadline_interactive, 0
    rng = _request_rng(tcfg.seed ^ _SLO_STREAM, rid)
    u = rng.rand()
    if u < tcfg.interactive_frac:
        prio, dl = "interactive", tcfg.deadline_interactive
    elif u < tcfg.interactive_frac + tcfg.batch_frac:
        prio, dl = "batch", tcfg.deadline_batch
    else:
        prio, dl = "best_effort", tcfg.deadline_best_effort
    tenant = int(rng.randint(0, max(tcfg.n_tenants, 1)))
    return prio, dl, tenant


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    n_requests: int = 16
    rate: float = 8.0                 # mean arrivals per second (Poisson)
    vocab: int = 128
    seed: int = 0
    # [lo, hi) token ranges; defaults keep prompt+output <= 32 (the
    # smoke configs' max_seq) so any engine bound >= 32 admits the trace
    prompt_short: tuple = (2, 10)
    prompt_long: tuple = (12, 24)
    long_frac: float = 0.25
    out_short: tuple = (2, 8)
    out_long: tuple = (6, 9)
    # per-request sampling policy (defaults: greedy, matching the old
    # traffic); greedy_frac forces that fraction of requests to greedy
    # regardless, so one trace can mix sampled and greedy streams
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    greedy_frac: float = 0.0
    # SLO traffic mix (serve.slo): class draw per request —
    # ``interactive_frac`` then ``batch_frac``, remainder best_effort —
    # relative TTFT deadlines per class (None = no SLO), and a tenant
    # id drawn uniformly from ``n_tenants`` for the fairness buckets.
    # Defaults (all interactive, no deadlines, one tenant) keep the
    # classic traces BYTE-IDENTICAL: the SLO draws come from a separate
    # derived RNG stream, so enabling them never shifts prompts.
    interactive_frac: float = 1.0
    batch_frac: float = 0.0
    deadline_interactive: Optional[float] = None
    deadline_batch: Optional[float] = None
    deadline_best_effort: Optional[float] = None
    n_tenants: int = 1


def _request_rng(seed: int, rid: int) -> np.random.RandomState:
    """One independent, reproducible stream per request id."""
    root = np.random.SeedSequence([int(seed), int(rid)])
    return np.random.RandomState(root.generate_state(1)[0])


def make_requests(tcfg: TrafficConfig) -> list:
    """The arrival trace: ``n_requests`` Requests with exponential
    inter-arrival gaps (rate ``rate``) and mixed prompt/output lengths.
    All of request ``i``'s draws (its gap included) come from the
    ``(seed, i)`` stream, interleaved per request — prefix-stable in
    ``n_requests``."""
    reqs = []
    t = 0.0
    for i in range(tcfg.n_requests):
        rng = _request_rng(tcfg.seed, i)
        gap = rng.exponential(1.0 / tcfg.rate)
        if i > 0:                                 # first request at t=0
            t += gap
        long = rng.rand() < tcfg.long_frac
        plen = rng.randint(*(tcfg.prompt_long if long
                             else tcfg.prompt_short))
        olen = rng.randint(*(tcfg.out_long if long else tcfg.out_short))
        prompt = rng.randint(0, tcfg.vocab, size=plen).tolist()
        greedy = rng.rand() < tcfg.greedy_frac
        sp = SamplingParams() if greedy else SamplingParams(
            temperature=tcfg.temperature, top_k=tcfg.top_k,
            top_p=tcfg.top_p)
        prio, deadline, tenant = _slo_attrs(tcfg, i)
        reqs.append(Request(rid=i, prompt=prompt, max_new=int(olen),
                            t_arrive=float(t), sampling=sp,
                            priority=prio, deadline=deadline,
                            tenant=tenant))
    return reqs
