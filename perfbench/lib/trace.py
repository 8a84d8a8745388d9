"""The traced window: ``torch.profiler`` over part of a run, reduced to
device busy time, time by kernel, and idle gaps by what the host was
doing.

The benchmark marks its own spans (``span``: ``perfbench.<name>``
annotations around the calls it makes into the program); an idle gap
on the device is named by the innermost such span around its middle.
The profiler's chrome trace is written to the temporary directory,
read, and deleted.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "perfbench."
WINDOW = PREFIX + "window"


def span(name: str):
    """A host span of the benchmark's own, seen in the trace."""
    return torch.profiler.record_function(PREFIX + name)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_events(events: list) -> dict:
    """The summary of one window's chrome-trace events (times in us):
    ``window_s``, ``busy_s``, ``kernels`` {name: [seconds, count]} and
    ``idle`` {host span: seconds}, all inside the ``perfbench.window``
    annotation."""
    wins = [e for e in events if e.get("name") == WINDOW
            and e.get("cat") == "user_annotation"]
    if not wins:
        raise RuntimeError("the trace holds no perfbench.window span")
    w0 = float(wins[0]["ts"])
    w1 = w0 + float(wins[0]["dur"])
    dev, kernels = [], {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e["dur"]), w1)
        if b <= a:
            continue
        dev.append((a, b))
        k = kernels.setdefault(str(e.get("name", "?"))[:160], [0.0, 0])
        k[0] += (b - a) * 1e-6
        k[1] += 1
    busy = _union(dev)
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
              e["name"][len(PREFIX):]) for e in events
             if e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith(PREFIX)
             and e["name"] != WINDOW and "dur" in e]
    idle: dict = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        inner = [s for s in spans if s[0] <= mid <= s[1]]
        label = min(inner, key=lambda s: s[1] - s[0])[2] if inner \
            else "outside the benchmark's spans"
        idle[label] = idle.get(label, 0.0) + (b - a) * 1e-6
    return {"window_s": (w1 - w0) * 1e-6,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "kernels": kernels, "idle": idle}


def kernel_seconds(summary: dict, match: str) -> tuple[float, int]:
    """Device seconds and launches of the kernels whose name holds
    ``match``."""
    s, n = 0.0, 0
    for name, (sec, cnt) in summary["kernels"].items():
        if match in name:
            s, n = s + sec, n + cnt
    return s, n


def breakdown(summary: dict, top: int = 10) -> dict:
    ops = sorted(summary["kernels"].items(), key=lambda kv: -kv[1][0])
    idle = sorted(summary["idle"].items(), key=lambda kv: -kv[1])
    return {"device_ops": [[n, v[0]] for n, v in ops[:top]],
            "idle_gaps": [[n, v] for n, v in idle[:top]]}


def warm() -> None:
    """Start and stop the profiler once (its first start takes seconds),
    so that the start inside a measured window is quick."""
    with Tracer():
        torch.zeros(1).add_(1)


class Tracer:
    """``with Tracer() as tr:`` profiles the block on the device and the
    host; ``tr.summary`` is ``reduce_events`` of it afterwards."""

    def __init__(self):
        self.summary = None
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self._prof = self._stack.enter_context(profile(activities=acts))
        self._stack.enter_context(torch.profiler.record_function(WINDOW))
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._stack.close()
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json", prefix="perfbench_")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.summary = reduce_events(events)
        return False
