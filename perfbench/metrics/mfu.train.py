"""The whole training step's share of the card's peak: 6 N T over the
matrix parameters plus the attention's causal pairs, forward and
backward, recompute not counted (``yardstick.counts.train_step_flops``),
over the steps' time and the peak of the precision the step's matrix
products ran in (f32 with TF32 off: 67 TFLOP/s; read at run time)."""
from perfbench.yardstick import counts, peaks

UNIT = "%"
LAYER = "whole step (train.step.make_train_step)"
MOVES = "train_tok_s"


def read(rec):
    if rec["kind"] != "train":
        return None
    mix = rec["mix"]
    flops = counts.train_step_flops(rec["config"], int(mix["rows"]),
                                    int(mix["seq"])) * len(rec["steps"])
    secs = sum(b - a for a, b in rec["steps"])
    peak = peaks.matmul_peak(rec["config"]["torch_dtype"], rec["tf32"])
    return 100.0 * flops / (secs * peak)
