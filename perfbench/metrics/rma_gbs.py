"""Put/get bandwidth: payload bytes delivered to each PE by the rounds
that completed inside the window, over the window, in GB/s (1e9)."""
from perfbench.lib import window

UNIT = "GB/s"
LAYER = None
MOVES = None


def read(rec):
    if rec["kind"] != "rma":
        return None
    return window.rate([(t, rec["payload_bytes_per_round"])
                        for t in rec["rounds"]], rec["window"]) / 1e9
