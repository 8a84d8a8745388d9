"""Training cells: the program's train step (``repro_torch.train.
make_train_step`` over ``train_state_from``: microbatched loss and
gradients through the flash kernel under remat, the global clip, AdamW
in place) on the configuration's layers, f32, TF32 off.

Set-up makes the weights on the device from the seed, builds the one
train state and step, and drives them through the first ``check_steps``
steps on the seed's first batches, through the same call and feed the
window uses; those are the steps the check compares (each step's loss,
the first gradient as the optimizer got it — worked out from AdamW's
first moment after one step — and each parameter's change after the
last of them).  The same state then trains on in the window, whole
steps only: a step starts while the window has room for one more of the
last one's length.  With ``--trace 1`` the profiler covers the window's
first step.  Afterwards the state is freed and the plain reference
(``reference.train``) runs the same steps from the same weights.
With ``--control tf32`` or ``--control half_batch`` that reference, run
with TF32 products or with half of each batch left out, is judged in
the program's place.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from perfbench.lib import gen, trace, weights
from perfbench.lib.qwen3 import program_config
from perfbench.reference import train as ref_train

CONTROLS = ("tf32", "half_batch")


def program_leaves(tree: dict) -> dict:
    """The leaves of the program's per-layer tree (``lm.unstack``'s
    form, its AdamW moments the same), by the reference's names."""
    out = {"embed": tree["embed"]["table"], "ln_f": tree["ln_f"]["scale"]}
    if "head" in tree:
        out["head"] = tree["head"]["table"]
    for li, p in enumerate(tree["blocks"]):
        a = p["attn"]
        named = {"ln1": p["ln1"]["scale"], "ln2": p["ln2"]["scale"],
                 "q_norm": a["q_norm"]["scale"],
                 "k_norm": a["k_norm"]["scale"],
                 **{k: a[k] for k in ("wq", "wk", "wv", "wo")},
                 **{k: p["mlp"][k] for k in ("wg", "wu", "wd")}}
        out.update({f"L{li}.{k}": v for k, v in named.items()})
    return out


def leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """The worst parameter's gap between the two norms, over the
    reference's norm of that parameter or of the median parameter,
    whichever is larger."""
    names = [n for n in ref if keep is None or n in keep]
    med = float(np.median([ref[n] for n in names]))
    return max(abs(prog[n] - ref[n]) / max(ref[n], med) for n in names)


def compare(prog: dict, ref: dict) -> list:
    """The numbers the check holds to its limits: the worst step's loss
    gap (relative), the first gradient's worst parameter, and the
    change's worst parameter among those whose reference gradient is
    not nought to rounding (a thousandth of the median parameter's or
    more)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                   ref["losses"]))
    med = float(np.median(list(ref["grad1"].values())))
    moved = {n for n, g in ref["grad1"].items() if g >= 1e-3 * med}
    return [("loss_gap", loss),
            ("grad1_leaf_gap", leaf_gap(prog["grad1"], ref["grad1"])),
            ("change_leaf_gap", leaf_gap(prog["change"], ref["change"],
                                         moved))]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(ctx) -> dict:
    from repro_torch.models import registry
    from repro_torch.parallel import ParallelCtx
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.step import train_state_from
    ctx.mark("import")
    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    t = cfg["train"]
    torch.backends.cuda.matmul.allow_tf32 = bool(t["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(t["tf32"])
    pcfg = program_config(cfg, int(mix["seq"]))
    pctx = ParallelCtx(remat=True, attn_impl=t["attn_impl"],
                       param_dtype=torch.float32,
                       compute_dtype=torch.float32)
    a = t["adamw"]
    opt = AdamWConfig(lr=a["lr"], b1=a["b1"], b2=a["b2"], eps=a["eps"],
                      weight_decay=a["weight_decay"])
    state = train_state_from(
        weights.stacked(cfg, ctx.seed, torch.float32, dev), pctx, opt, pcfg)
    step_fn = ctx.patch_engine(make_train_step(
        pcfg, pctx, registry.build(pcfg), opt,
        microbatches=int(mix["microbatches"]), clip_norm=t["clip_norm"]))
    batches = gen.TrainBatches(mix, cfg["vocab_size"], ctx.seed)
    rows, seq = int(mix["rows"]), int(mix["seq"])
    _sync(dev)
    ctx.mark("weights and state")

    def step(s):
        nonlocal state
        tokens = torch.from_numpy(batches.batch(s)).to(dev)
        state, m = step_fn(state, {"tokens": tokens})
        return float(m["loss"])

    n_check = int(t["check_steps"])
    prog = {"losses": []}
    for s in range(n_check):
        prog["losses"].append(step(s))
        if s == 0:
            with torch.no_grad():
                prog["grad1"] = {
                    n: float(torch.linalg.vector_norm(v)) / (1 - opt.b1)
                    for n, v in program_leaves(state["opt"]["m"]).items()}
    ctx.mark("checked steps")
    with torch.no_grad():
        prog["change"] = ref_train.changes(program_leaves(state["params"]),
                                           cfg, ctx.seed, dev)
    if ctx.trace:
        trace.warm()
    _sync(dev)
    t_open = time.monotonic()
    ctx.window_opened(t_open)
    steps, losses, tracer, s = [], [], None, n_check
    while True:
        last = steps[-1][1] - steps[-1][0] if steps else 0.0
        now = time.monotonic()
        if steps and now - t_open + last > ctx.seconds:
            break
        with contextlib.ExitStack() as traced:
            if ctx.trace and not steps:
                tracer = traced.enter_context(trace.Tracer())
                traced.enter_context(trace.span("step"))
            losses.append(step(s))
            steps.append((now, time.monotonic()))
        s += 1
    window = (t_open, steps[-1][1])
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    rec = {"kind": "train", "window": window, "config": cfg, "mix": dict(mix),
           "steps": steps, "tokens_per_step": rows * seq,
           "tf32": bool(torch.backends.cuda.matmul.allow_tf32),
           "memory_peak_bytes": int(peak),
           "trace": tracer.summary if tracer is not None else None,
           "attempted": len(steps),
           "failed": sum(1 for x in losses if not np.isfinite(x))}
    del state, step_fn
    ctx.free()
    t_ref = time.monotonic()
    ref = ref_train.run(cfg, mix, ctx.seed, dev, steps=n_check)
    info = {"reference_s": time.monotonic() - t_ref,
            "losses": prog["losses"], "reference_losses": ref["losses"]}
    found = compare(prog, ref)
    if ctx.control:
        # the control, the reference run one precision down or with half
        # of each batch left out, is judged in the program's place
        info["program"] = dict(found)
        found = compare(ref_train.run(cfg, mix, ctx.seed, dev,
                                      steps=n_check, **{ctx.control: True}),
                        ref)
    limits = cfg["limits"]
    rec["checks"] = [(n, v, float(limits[n])) for n, v in found]
    rec["check_info"] = info
    return rec
