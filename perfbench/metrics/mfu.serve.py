"""The whole serving step's share of the card's peak: the model
operations of the window's work (every prefilled token's forward at its
position, every decoded token's, the head for every generated token;
active experts only, no capacity padding; ``yardstick.counts``) over
the window times the peak of the served dtype."""
from perfbench.lib import window
from perfbench.yardstick import counts, peaks

UNIT = "%"
LAYER = "whole step (serve.engine.ServeEngine.tick)"
MOVES = "tok_s"


def read(rec):
    if rec["kind"] != "serve":
        return None
    cfg, w = rec["config"], rec["window"]
    flops = 0.0
    for _, starts, n_toks in rec["prefill_calls"]:
        flops += sum(counts.forward_flops(cfg, int(s), int(n))
                     for s, n in zip(starts, n_toks) if n > 0)
    head = counts.head_flops(cfg)
    for r in rec["requests"]:
        for k, t in enumerate(r["times"]):
            if not window.inside(t, w):
                continue
            flops += head
            if k:
                flops += counts.forward_flops(cfg, r["n_prompt"] + k - 1, 1)
    return 100.0 * flops / (window.length(w) *
                            peaks.FLOPS[cfg["torch_dtype"]])
