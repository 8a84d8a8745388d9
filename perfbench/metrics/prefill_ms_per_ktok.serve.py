"""Device time of the program's prefill step (``make_prefill`` through
``LocalExec.prefill``, between CUDA events the benchmark places around
each call), per 1024 prompt tokens, over the window's calls."""

UNIT = "ms"
LAYER = "model step (serve.engine.make_prefill)"
MOVES = "tok_s"


def read(rec):
    if rec["kind"] != "serve" or not rec["prefill_calls"]:
        return None
    ms = sum(m for m, _, _ in rec["prefill_calls"])
    tokens = sum(int(n.sum()) for _, _, n in rec["prefill_calls"])
    return 1024.0 * ms / tokens if tokens else None
