"""The harness: from a cell's name to its result line.

``BENCHMARK.json`` names each cell's configuration and traffic; the
configuration's file names its ``kind``.  The harness loads
``kinds/<kind>.py`` and runs it once, then asks each metric's reader
(``metrics/<name>.py``) for its number: with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer ones.  A reader
that finds nothing returns None and its metric is left out.

The kind returns a record of the run: its window, what happened in it,
the peak memory read when the window closed, the reduced trace, and the
numbers the correctness check compared with their limits (``checks``).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Callable, Optional

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_module(path: Path, name: str):
    """A module from a file, by path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(names) -> list:
    """The loaded modules whose top-level name is one the benchmark's
    process must not hold, compared whole (``repro_torch`` is not
    ``repro``)."""
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def bench_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell_of(spec: dict, workload: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                   f"({', '.join(w['name'] for w in spec['workloads'])})")


def config_of(spec: dict, name: str, root: Path = ROOT) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def mix_of(name: str, bench_dir: Path = HERE) -> dict:
    with open(bench_dir / "traffic" / f"{name}.json") as f:
        return json.load(f)


def metrics_for(spec: dict, workload: str, trace: bool) -> list:
    """The cell's metric entries of the run's kind (per-layer when
    traced), each one that names no ``workloads`` or names this cell."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def reader(name: str, bench_dir: Path = HERE):
    return load_module(bench_dir / "metrics" / f"{name}.py",
                       f"perfbench_metric_{name.replace('.', '_')}")


@dataclasses.dataclass
class Context:
    """What a kind's ``run`` gets: the cell's inputs and the hooks the
    harness keeps (the window's opening time, freeing the program's
    state, and ``patch_engine`` / ``patch_step`` for the CPU tests that
    break the timed path on purpose)."""

    workload: str
    config: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    control: Optional[str] = None
    patch_engine: Callable = lambda obj: obj
    opened: Optional[float] = None
    marks: list = dataclasses.field(default_factory=list)

    def mark(self, phase: str) -> None:
        """Note that a phase of set-up ended now (printed on standard
        error, so that where set-up goes is seen)."""
        self.marks.append((phase, time.monotonic()))

    def window_opened(self, t: float) -> None:
        self.mark("warm-up")
        self.opened = t

    def setup_phases(self) -> list:
        """(phase, seconds) of set-up, from the process's start."""
        out, t = [], self.t_start
        for phase, end in self.marks:
            out.append((phase, end - t))
            t = end
        return out

    def free(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device=None, t_start: Optional[float] = None, control=None,
             patch_engine=None, root: Path = ROOT,
             bench_dir: Path = HERE) -> dict:
    """Run one cell once; returns the result line's object (with the
    compared numbers under ``checks``, last)."""
    t_start = time.monotonic() if t_start is None else t_start
    spec = bench_spec(root)
    cell = cell_of(spec, workload)
    cfg = config_of(spec, cell["config"], root)
    mix = mix_of(cell["traffic"], bench_dir)
    dev = torch.device(device or "cuda")
    kind = load_module(bench_dir / "kinds" / f"{cfg['kind']}.py",
                       f"perfbench_kind_{cfg['kind']}")
    if control is not None and control not in getattr(kind, "CONTROLS", ()):
        raise ValueError(f"{cfg['kind']} cells have the controls "
                         f"{getattr(kind, 'CONTROLS', ())}, not {control!r}")
    ctx = Context(workload, cfg, mix, int(seed), float(seconds), bool(trace),
                  dev, t_start, control)
    ctx.mark("start")
    if patch_engine is not None:
        ctx.patch_engine = patch_engine
    rec = kind.run(ctx)
    rec["setup_s"] = ctx.opened - t_start
    rec["setup_phases"] = ctx.setup_phases()
    metrics = {}
    for m in metrics_for(spec, workload, trace):
        value = reader(m["name"], bench_dir).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev)
                   if dev.type == "cuda" else "cpu",
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    out = {"correct": all(v <= lim for _, v, lim in rec["checks"]),
           "attempted": int(rec["attempted"]), "failed": int(rec["failed"]),
           "metrics": metrics, "device": device_info}
    if trace:
        from perfbench.lib import trace as tr
        s = rec["trace"]
        device_info["busy_s"] = s["busy_s"]
        device_info["window_s"] = s["window_s"]
        out["breakdown"] = tr.breakdown(s)
    out["info"] = dict(rec.get("check_info", {}),
                       setup_phases=rec["setup_phases"])
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in rec["checks"]}
    return out


def process_start() -> float:
    """This process's start on the ``time.monotonic`` clock (Linux:
    from ``/proc``; elsewhere, now)."""
    now = time.monotonic()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return now - max(0.0, up - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


def main(argv, t0: float) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json "
                                 "once and print its result line.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None,
                    help="judge the cell's control (a lower precision or "
                         "a broken guarantee, one of the kind's CONTROLS) "
                         "in the program's place, for setting limits: a "
                         "sound limit makes such a run not correct")
    args = ap.parse_args(argv)
    # one process with few threads: the host paces much of the serving
    torch.set_num_threads(1)
    spec = bench_spec()
    chips = int(cell_of(spec, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   t_start=t0, control=args.control)
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"perfbench: the process holds {', '.join(bad)}: the "
              f"benchmark runs the port alone", file=sys.stderr)
        return 4
    print("setup phases: " + ", ".join(
        f"{p} {sec:.2f} s" for p, sec in out["info"]["setup_phases"]),
        file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out))
    return 0
