"""Window arithmetic: what an end-to-end metric takes from a measured
window ``(t_open, t_close)`` on the host clock.

A rate counts every unit of work that completed inside the window,
requests still in flight included, over the whole window; a tail is
taken over every sample that fell in it.  Nothing is left out to quiet
a number: a stall inside the window lowers the rate and lengthens the
tail together.
"""
from __future__ import annotations

import numpy as np


def inside(t, window) -> bool:
    """Whether time ``t`` falls in the window (open at its start)."""
    return t is not None and window[0] < t <= window[1]


def length(window) -> float:
    return float(window[1] - window[0])


def rate(done, window) -> float:
    """Units per second: ``done`` is ``(t, units)`` pairs, each the time
    some work completed and how much it was."""
    return sum(u for t, u in done if inside(t, window)) / length(window)


def percentile(values, q: float):
    """The ``q``-th percentile (numpy's linear rule), None for none."""
    v = np.asarray(list(values), dtype=np.float64)
    return float(np.percentile(v, q)) if v.size else None


def first_token_latencies(requests, window) -> list:
    """Submit-to-first-token of every request whose first token was
    delivered inside the window (``t_submit``, ``times``: the delivery
    time of each token)."""
    return [r["times"][0] - r["t_submit"] for r in requests
            if r["times"] and inside(r["times"][0], window)]


def token_gaps(requests, window) -> list:
    """Every gap between two consecutive tokens of a request, whose
    later token was delivered inside the window."""
    out = []
    for r in requests:
        ts = r["times"]
        out += [b - a for a, b in zip(ts, ts[1:]) if inside(b, window)]
    return out
