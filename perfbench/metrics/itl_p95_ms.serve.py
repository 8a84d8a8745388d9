"""The 95th percentile of the gaps between consecutive tokens of a
request, every gap whose later token was delivered in the window (host
clock: paced by the host as much as by the card)."""
from perfbench.lib import window

UNIT = "ms"
LAYER = "serve engine tick (serve.engine.ServeEngine.tick)"
MOVES = "tok_s"


def read(rec):
    if rec["kind"] != "serve":
        return None
    p = window.percentile(window.token_gaps(rec["requests"], rec["window"]),
                          95)
    return None if p is None else 1e3 * p
