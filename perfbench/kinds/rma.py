"""Put/get cells: an OpenSHMEM program's large one-sided transfers through
the program's symmetric heap (``repro_torch.core.SymmetricHeap``) and
ordered queue (``repro_torch.core.CommQueue``) on the stacked team of
``n_pe`` PEs on one card.

Round ``r`` issues, for each of the mix's ``slots`` symmetric blocks of
``elems`` elements a PE, a ``put_nbi`` of a seeded pattern from every
PE to PE + 1 and a ``get_nbi`` by every PE of PE - 1's block, then one
``quiet`` (a quiet after every ``quiet_every`` operations).  Set-up
makes the patterns on the device from the seed and runs ``warm_rounds``
rounds.  The window runs rounds until ``--seconds`` have passed, each
ending in a synchronize; about one round in ``sample_every`` (drawn
from the seed) keeps its delivered blocks and fetched values, and
after the window every kept answer is compared, element for element,
with the plain reference (``reference.rma``).
"""
from __future__ import annotations

import contextlib
import time

import torch

from perfbench.lib import gen, trace
from perfbench.reference import rma as ref_rma

CONTROLS = ("misdeliver",)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int32": torch.int32}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(ctx) -> dict:
    from repro_torch.core import CommQueue, SymmetricHeap
    ctx.mark("import")
    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    n_pe, elems = int(cfg["n_pe"]), int(cfg["elems"])
    dtype = DTYPES[cfg["dtype"]]
    plan = gen.RmaPlan(mix, ctx.seed)
    slots = int(mix["slots"])
    if plan.ops != ["put", "get"] * slots or plan.quiet_every != 2 * slots:
        raise ValueError("the rma kind runs rounds of a put and a get per "
                         "slot, then one quiet")
    heap = SymmetricHeap(("pe",))
    handles = [heap.alloc(f"block{k}", (elems,), dtype) for k in range(slots)]
    state = heap.zeros_state(n_pe, device=dev)
    patterns = ref_rma.patterns(ctx.seed, plan.patterns, n_pe, elems, dtype,
                                dev)
    put_pairs = [(i, (i + ctx_shift(ctx)) % n_pe) for i in range(n_pe)]
    get_pairs = [((i - 1) % n_pe, i) for i in range(n_pe)]

    def round_(r):
        nonlocal state
        q = ctx.patch_engine(CommQueue("pe", state))
        got = []
        for k, h in enumerate(handles):
            q.put_nbi(h, patterns[plan.pattern(r, k)], put_pairs)
            got.append(q.get_nbi(h, get_pairs))
        state = q.quiet()
        return [state[h.name] for h in handles], [g.value() for g in got]

    _sync(dev)
    ctx.mark("heap and payloads")
    for r in range(int(mix["warm_rounds"])):
        round_(r)
    if ctx.trace:
        trace.warm()
    _sync(dev)
    t_open = time.monotonic()
    ctx.window_opened(t_open)
    r0 = r = int(mix["warm_rounds"])
    done, kept, tracer = [], {}, None
    trace_from = max(0.0, ctx.seconds - float(mix["trace_seconds"]))
    with contextlib.ExitStack() as stack:
        while time.monotonic() - t_open < ctx.seconds:
            if ctx.trace and tracer is None and \
                    time.monotonic() - t_open >= trace_from:
                tracer = stack.enter_context(trace.Tracer())
            with (trace.span("round") if tracer is not None
                  else contextlib.nullcontext()):
                blocks, values = round_(r)
                _sync(dev)
            done.append(time.monotonic())
            if plan.sampled(r):
                kept[r] = (blocks, values)
            r += 1
    kept.setdefault(r - 1, (blocks, values))
    window = (t_open, done[-1])
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    per_round = len(plan.ops) * elems * torch.empty(
        (), dtype=dtype).element_size()
    rec = {"kind": "rma", "window": window, "config": cfg, "mix": dict(mix),
           "rounds": done, "payload_bytes_per_round": per_round,
           "n_pe": n_pe, "memory_peak_bytes": int(peak),
           "trace": tracer.summary if tracer is not None else None,
           "attempted": (r - r0) * len(plan.ops)}
    wrong = sum(ref_rma.mismatches(patterns, plan, rnd, blocks, values)
                for rnd, (blocks, values) in kept.items())
    rec["failed"] = sum(
        1 for rnd, (blocks, values) in kept.items()
        if ref_rma.mismatches(patterns, plan, rnd, blocks, values))
    rec["checks"] = [("mismatched_elements", float(wrong),
                      float(cfg["limits"]["mismatched_elements"]))]
    rec["check_info"] = {"rounds_checked": len(kept),
                         "rounds": r - r0}
    return rec


def ctx_shift(ctx) -> int:
    """The put's destination offset: PE + 1, or, as the control that
    breaks the configuration's delivery guarantee, PE + 2."""
    return 2 if ctx.control == "misdeliver" else 1
