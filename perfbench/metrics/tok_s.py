"""Serving throughput: prompt tokens prefilled plus tokens generated by
the ticks that ended inside the window, over the whole window."""
from perfbench.lib import window

UNIT = "tokens/s"
LAYER = None
MOVES = None


def read(rec):
    if rec["kind"] != "serve":
        return None
    return window.rate([(t["t1"], t["prefill_tokens"] + t["generated"])
                        for t in rec["ticks"]], rec["window"])
