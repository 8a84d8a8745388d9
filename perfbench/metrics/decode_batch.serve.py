"""Sequences a decode step carries: the window's decoded tokens over its
decode steps (the scheduler's batching of decode)."""
from perfbench.lib import window

UNIT = "seqs"
LAYER = "scheduler (serve.scheduler)"
MOVES = "tok_s"


def read(rec):
    if rec["kind"] != "serve":
        return None
    ticks = [t for t in rec["ticks"] if window.inside(t["t1"], rec["window"])]
    steps = sum(t["decode_steps"] for t in ticks)
    if not steps:
        return None
    return sum(t["generated"] - t["first"] for t in ticks) / steps
