"""The flash kernel's share of its roofline in the traced training step:
the least time of the causal forwards the step needs, one for every row
at every layer (``yardstick.counts.flash_bound_s``, f32 on the CUDA
cores; a forward computed again under remat is not counted), over the
profiler's time of the kernels whose name holds ``flash_fwd``."""
from perfbench.lib import trace
from perfbench.yardstick import counts, peaks

UNIT = "%"
LAYER = "kernels (kernels/csrc/flash_attention.cu)"
MOVES = "train_tok_s"
MATCH = "flash_fwd"


def read(rec):
    if rec["kind"] != "train" or rec["trace"] is None:
        return None
    secs, launches = trace.kernel_seconds(rec["trace"], MATCH)
    if not launches or secs <= 0:
        return None
    cfg, mix = rec["config"], rec["mix"]
    d = int(cfg["hidden_size"])
    h = int(cfg["num_attention_heads"])
    dtype = cfg["torch_dtype"]
    bound = counts.flash_bound_s(
        int(mix["rows"]), h, int(cfg["num_key_value_heads"]), int(mix["seq"]),
        int(cfg.get("head_dim", d // h)), 2 if dtype == "bfloat16" else 4,
        peaks.FLOPS[dtype])
    return 100.0 * bound * int(cfg["num_hidden_layers"]) / secs
