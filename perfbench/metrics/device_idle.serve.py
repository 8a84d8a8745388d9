"""Share of the traced window in which no kernel, copy or fill ran on
the card (the profiler's trace), in a serving cell."""

UNIT = "%"
LAYER = "device"
MOVES = "tok_s"
KIND = "serve"


def read(rec):
    if rec["kind"] != KIND or rec["trace"] is None:
        return None
    s = rec["trace"]
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
