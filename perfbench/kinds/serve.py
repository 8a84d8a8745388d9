"""Serving cells: the program's ``repro_torch.serve.ServeEngine`` over its
paged KV cache, driven tick by tick by a closed loop of clients.

Set-up makes the weights on the device from the seed
(``lib.weights.stacked``), builds the engine with the configuration's
serving settings, and serves ``warm_requests`` short requests of a
separate stream until they are done (at least ``warm_ticks`` ticks):
every shape the window uses (the fixed prefill window and decode
batch) is built and run before it opens.  The window opens with every
client submitting its first request and runs ticks until ``--seconds``
have passed; it closes at the end of that tick.  A token is delivered
when the tick that made it returns; a client whose request finished
submits its next one at once.  With ``--trace 1`` the profiler covers
the window's last ``trace_seconds``.

Afterwards the engine is freed and the plain reference
(``reference.decoder``) runs over a sample of the finished requests,
drawn from the seed with the longest among them: the gaps by which the
served tokens' logits lie below the reference's best, each statistic
the configuration's ``limits`` name (the widest, or the mean), decide
``correct``.  With ``--control fp8`` the float8 stream's gaps are judged
in their place.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from perfbench.lib import gen, trace, weights
from perfbench.lib.qwen3 import program_config
from perfbench.reference import decoder as ref_decoder

WARM_RID = 1 << 30
CONTROLS = ("fp8",)


class Client:
    """One closed-loop client's request as the loop sees it."""

    def __init__(self, rid, prompt, n_out, t_submit, req):
        self.rid, self.prompt, self.n_out = rid, prompt, n_out
        self.t_submit, self.req = t_submit, req
        self.times: list = []

    def as_record(self) -> dict:
        return {"rid": self.rid, "t_submit": self.t_submit,
                "times": list(self.times), "n_prompt": len(self.prompt),
                "n_out": self.n_out}


class Loop:
    """A closed loop of ``clients`` over the engine: ``tick`` runs one
    engine tick and delivers its tokens at the tick's end."""

    def __init__(self, eng, stream, clock, tracing):
        self.eng, self.stream, self.clock = eng, stream, clock
        self.tracing = tracing
        self.live: dict = {}
        self.done: list = []
        self.ticks: list = []
        self.next_rid = 0
        self.closed = False        # a finished client sends no more

    def submit(self, now, prompt=None, n_out=None, rid=None):
        """Submit the stream's next request (or the one given)."""
        from repro_torch.serve import Request
        if rid is None:
            rid = self.next_rid
            self.next_rid += 1
            prompt, n_out = self.stream.request(rid)
        req = Request(rid=rid, prompt=prompt, max_new=n_out, t_arrive=now)
        self.eng.submit(req)
        self.live[rid] = Client(rid, prompt, n_out, now, req)

    def _span(self, name):
        return trace.span(name) if self.tracing() else contextlib.nullcontext()

    def tick(self):
        eng = self.eng
        pf0, dec0 = eng.sched.stats["prefill_tokens"], eng.steps["decode"]
        t0 = self.clock()
        with self._span("tick"):
            eng.tick(t0)
        t1 = self.clock()
        new = first = 0
        for c in list(self.live.values()):
            k = len(c.req.out) - len(c.times)
            if k > 0:
                first += not c.times
                c.times += [t1] * k
                new += k
            if c.req.t_finish is not None and len(c.times) >= c.n_out:
                del self.live[c.rid]
                if not self.closed:
                    self.done.append(c)
                    self.submit(t1)
        self.ticks.append({"t0": t0, "t1": t1,
                           "prefill_tokens": eng.sched.stats["prefill_tokens"]
                           - pf0, "generated": new, "first": first,
                           "decode_steps": eng.steps["decode"] - dec0})


class StepTimer:
    """The benchmark's CUDA events around each prefill call of the
    program's exec (host clock on the CPU), with the call's rows."""

    def __init__(self, exec_, device, loop):
        self.calls: list = []
        self.device = device
        pre, dec = exec_.prefill, exec_.decode

        def prefill(pool, ids, start, n_tok, bt, samp):
            with loop._span("prefill_step"):
                ev = self._mark()
                out = pre(pool, ids, start, n_tok, bt, samp)
                ev.append(self._mark()[0])
            self.calls.append((ev, loop.clock(), start.copy(), n_tok.copy(),
                               loop.tracing()))
            return out

        def decode(pool, tokens, pos, bt, lens, samp):
            with loop._span("decode_step"):
                return dec(pool, tokens, pos, bt, lens, samp)

        exec_.prefill, exec_.decode = prefill, decode

    def _mark(self):
        if self.device.type != "cuda":
            return [time.perf_counter()]
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return [e]

    def rows(self, window) -> list:
        """Each prefill call that ended inside the window: (device ms,
        starts, n_toks)."""
        out = []
        for ev, t, start, n_tok, _ in self.calls:
            if not window[0] < t <= window[1]:
                continue
            ms = ev[0].elapsed_time(ev[1]) if self.device.type == "cuda" \
                else (ev[1] - ev[0]) * 1e3
            out.append((ms, start, n_tok))
        return out

    def traced_rows(self) -> list:
        """(starts, n_toks) of each call made while the profiler ran."""
        return [(start, n_tok) for _, _, start, n_tok, traced in self.calls
                if traced]


def sample_requests(done: list, seed: int, want_tokens: int) -> list:
    """The finished requests the reference checks: the longest, then a
    draw from the seed weighted by served tokens, until ``want_tokens``
    served tokens are in."""
    if not done:
        return []
    longest = max(done, key=lambda c: (len(c.prompt) + c.n_out, c.rid))
    pick, n = [longest], longest.n_out
    rest = [c for c in done if c is not longest]
    r = gen.rng(seed, 5)
    while rest and n < want_tokens:
        p = np.array([c.n_out for c in rest], np.float64)
        c = rest.pop(int(r.choice(len(rest), p=p / p.sum())))
        pick.append(c)
        n += c.n_out
    return pick


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(ctx) -> dict:
    from repro_torch.serve import ServeConfig, ServeEngine
    ctx.mark("import")
    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    s = cfg["serve"]
    dtype = weights.DTYPES[cfg["torch_dtype"]]
    pcfg = program_config(cfg, s["max_seq"])
    scfg = ServeConfig(
        page_tokens=s["page_tokens"], n_pages=s["n_pages"],
        max_batch=s["max_batch"], max_seq=s["max_seq"],
        prefill_chunk=s["prefill_chunk"], tick_tokens=s["tick_tokens"],
        attn_impl=s["attn_impl"], dtype=dtype)
    params = weights.stacked(cfg, ctx.seed, dtype, dev)
    _sync(dev)
    ctx.mark("weights")
    eng = ServeEngine(params, pcfg, scfg, device=dev)
    del params
    _sync(dev)
    ctx.mark("engine")
    stream = gen.ServeStream(mix, cfg["vocab_size"], ctx.seed)
    tracing = [False]
    loop = Loop(eng, stream, time.monotonic, lambda: tracing[0])
    timer = StepTimer(eng.exec, dev, loop)
    ctx.patch_engine(eng)
    # warm-up: short requests of their own stream, until all are done
    loop.closed = True
    warm = gen.rng(ctx.seed, 6)
    for i in range(int(s["warm_requests"])):
        loop.submit(loop.clock(), warm.integers(
            0, cfg["vocab_size"], 2 * s["prefill_chunk"]).astype(np.int32),
            2, rid=WARM_RID + i)
    while loop.live or len(loop.ticks) < int(s["warm_ticks"]):
        loop.tick()
    if ctx.trace:
        trace.warm()
    _sync(dev)
    loop.closed = False
    t_open = loop.clock()
    ctx.window_opened(t_open)
    for _ in range(int(mix["clients"])):
        loop.submit(t_open)
    first = len(loop.ticks)
    tracer = None
    trace_from = t_open + max(0.0, ctx.seconds - float(s["trace_seconds"]))
    with contextlib.ExitStack() as stack:
        while loop.clock() - t_open < ctx.seconds:
            if ctx.trace and tracer is None and loop.clock() >= trace_from:
                tracer = stack.enter_context(trace.Tracer())
                tracing[0] = True
            loop.tick()
        tracing[0] = False
    window = (t_open, loop.ticks[-1]["t1"])
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    records = [c.as_record() for c in loop.done] + \
        [c.as_record() for c in loop.live.values()]
    rec = {"kind": "serve", "window": window, "config": cfg,
           "serve": dict(s), "ticks": loop.ticks[first:],
           "requests": records, "prefill_calls": timer.rows(window),
           "traced_prefill_rows": timer.traced_rows(),
           "memory_peak_bytes": int(peak),
           "trace": tracer.summary if tracer is not None else None}
    rec["attempted"] = sum(1 for r in records
                           if r["times"] and window[0] < r["times"][0]
                           <= window[1])
    rec["failed"] = 0
    sample = sample_requests(loop.done, ctx.seed, int(s["check_tokens"]))
    seqs = [(c.prompt, list(c.req.out[:c.n_out])) for c in sample]
    del loop, timer, eng
    ctx.free()
    t_ref = time.monotonic()
    res = ref_decoder.served_gaps(cfg, ctx.seed, seqs, dev,
                                  control=ctx.control)
    res["reference_s"] = time.monotonic() - t_ref
    # with a control, its readings stand in the program's place, so a
    # control run is judged by the same limits (and the program's
    # readings are kept beside them)
    judged = "control_" if ctx.control else ""
    limits = cfg["limits"]
    rec["checks"] = [(n, res.pop(judged + n), float(lim))
                     for n, lim in limits.items()]
    rec["check_info"] = {"sampled_requests": len(seqs),
                         "served_tokens": res.pop("tokens"), **res}
    return rec
