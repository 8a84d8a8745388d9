"""The paged prefill kernel's share of its roofline: the least time of
every traced prefill call's attention, layer by layer (its rows' causal
pairs, their queries, keys, values and outputs once;
``yardstick.counts.paged_prefill_bound_s``), over the profiler's time of
the kernels whose name holds ``paged_prefill``."""
from perfbench.lib import trace
from perfbench.yardstick import counts

UNIT = "%"
LAYER = "kernels (kernels/csrc/paged_attention.cu, prefill)"
MOVES = "tok_s"
MATCH = "paged_prefill"


def read(rec):
    if rec["kind"] != "serve" or rec["trace"] is None:
        return None
    secs, launches = trace.kernel_seconds(rec["trace"], MATCH)
    if not launches or secs <= 0:
        return None
    cfg = rec["config"]
    dtype = cfg["torch_dtype"]
    size = 2 if dtype == "bfloat16" else 4
    bound = sum(counts.paged_prefill_bound_s(cfg, s, n, size, dtype)
                for s, n in rec["traced_prefill_rows"])
    return 100.0 * bound * int(cfg["num_hidden_layers"]) / secs
