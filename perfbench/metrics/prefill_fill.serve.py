"""Prompt tokens a prefill step carries, as a share of the tick's token
budget (``tick_tokens``), over the window's prefill steps."""

UNIT = "%"
LAYER = "scheduler (serve.scheduler)"
MOVES = "ttft_p95_ms"


def read(rec):
    if rec["kind"] != "serve" or not rec["prefill_calls"]:
        return None
    tokens = sum(int(n.sum()) for _, _, n in rec["prefill_calls"])
    return 100.0 * tokens / (len(rec["prefill_calls"]) *
                             rec["serve"]["tick_tokens"])
