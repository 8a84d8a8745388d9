"""Training throughput: the tokens of the window's whole steps over the
whole window (the steps run back to back from the window's opening, and
the window closes at the end of the last)."""
from perfbench.lib import window

UNIT = "tokens/s"
LAYER = None
MOVES = None


def read(rec):
    if rec["kind"] != "train":
        return None
    return rec["tokens_per_step"] * len(rec["steps"]) / \
        window.length(rec["window"])
