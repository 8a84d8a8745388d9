"""The 95th percentile of submit-to-first-token over every request whose
first token was delivered inside the window."""
from perfbench.lib import window

UNIT = "ms"
LAYER = None
MOVES = None


def read(rec):
    if rec["kind"] != "serve":
        return None
    p = window.percentile(
        window.first_token_latencies(rec["requests"], rec["window"]), 95)
    return None if p is None else 1e3 * p
