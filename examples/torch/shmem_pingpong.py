#!/usr/bin/env python
"""The paper's own experiment on the PyTorch port: put/get latency and
bandwidth through the POSH layer against a local copy (Tables 1–2), on
the stacked team of 8 PEs, over posh-micro's buffer sizes, dtypes,
warm-ups and repeats — plus the nonblocking pipeline: K puts issued
``put_nbi`` and drained by one ``quiet()`` against K blocking
``heap_put`` rounds (§3.2 overlap).

    PYTHONPATH=src python examples/torch/shmem_pingpong.py [--smoke]
        [--device cpu] [--json FILE]

Runs on the GPU unless ``--device cpu`` is given (the plain versions of
the kernels); ``--smoke`` takes posh-micro's smoke config.  Every row is
run under two stagers — the §4.4 memcpy seam of ``core.p2p``:
``default`` (no stager: each round's payload moves as it is) and
``copy`` (``p2p.staged_payloads`` with the copy engine,
``kernels.symm_copy``, the variant chosen from one PE's payload bytes,
as the ``pallas`` communicator backend stages its rounds).  The ops,
each on an ``(8, elems)`` tensor (every PE's buffer on the leading
axis):

  put    ``p2p.put`` over the ring pairs (i -> i+1): one put round.  The
         reference's example times ``ring_shift``, a bare ppermute; the
         port's ``ring_shift`` is a ``torch.roll`` that, like the
         reference's, bypasses the stage seam, so the put row is
         ``p2p.put`` over the same pairs — the same data motion;
  get    ``p2p.get`` with each PE reading PE i+1's buffer;
  nbi    the buffer in K = 8 chunks, each ``CommQueue.put_nbi`` to the
         next PE, then one ``quiet()`` (the drain coalesces the K
         adjacent puts into one round);
  copy   a local copy (``clone``).

and the pipeline at K = 8 chunks of 16384 elements (of the largest
buffer size, if smaller: 256 in the smoke config): ``nbi`` against
``blocking`` (K ``p2p.heap_put`` rounds, each ordered after the last).
Each cell runs ``warmup`` calls (the first one's result is checked: the
input rolled by the round's pairs, bit for bit) and ``repeats`` timed
calls ending in a synchronize: microseconds a call and per-PE GB/s (one
PE's bytes over the time), host clock, what an eager caller waits for.
On the card the copy stager's launches of the copy kernel are counted
and held to the staged rounds (``staged_rounds``).  Exits 1 if a check
fails.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from repro_torch import configs
from repro_torch.core import CommQueue, SymmetricHeap, p2p
from repro_torch.device import resolve
from repro_torch.kernels import ops, symm_copy

N_PE = 8
K = 8                       # pipeline depth
PIPE_ELEMS = 16384          # elements a pipeline chunk (at most)
RING = [(i, (i + 1) % N_PE) for i in range(N_PE)]
GET_PAIRS = [((i + 1) % N_PE, i) for i in range(N_PE)]   # (owner, reader)
SWEEP_OPS = ("put", "get", "nbi", "copy")
STAGERS = ("default", "copy")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int32": torch.int32}
# the input each op's output is held to, rolled along the PE axis
SHIFT = {"put": 1, "get": -1, "nbi": 1, "blocking": 1, "copy": 0}


def copy_stager(payload: torch.Tensor) -> torch.Tensor:
    """Stage one round's stacked payload through the copy engine, the
    variant chosen from one PE's bytes (the pallas backend's rule)."""
    nbytes = payload[0].numel() * payload.element_size()
    return ops.symm_copy(payload, symm_copy.choose_variant(nbytes,
                                                           payload.dtype))


def staged_rounds(op: str, elems: int, dtype) -> list:
    """Per-PE payload bytes of each round one call of ``op`` stages."""
    b = elems * torch.empty((), dtype=dtype).element_size()
    if op in ("put", "get", "nbi"):       # nbi: K puts coalesced to one
        return [b]
    if op == "blocking":
        return [b // K] * K
    return []


def expected_launches(op: str, elems: int, dtype) -> int:
    """Copy-kernel launches of one call under the copy stager: rounds
    whose payload is not left to the bare ("stock") copy."""
    return sum(1 for nb in staged_rounds(op, elems, dtype)
               if symm_copy.choose_variant(nb, dtype) != "stock")


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    view = ints[a.element_size()]
    return torch.equal(a.contiguous().view(view), b.contiguous().view(view))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def make_op(op: str, x: torch.Tensor):
    """The callable one cell times, over ``x`` (8, elems)."""
    if op == "put":
        return lambda: p2p.put(x, RING, "pe")
    if op == "get":
        return lambda: p2p.get(x, GET_PAIRS, "pe")
    if op == "copy":
        return x.clone
    elems = x.shape[1]
    chunk = elems // K
    heap = SymmetricHeap(("pe",))
    h = heap.alloc("pipe", (elems,), x.dtype)
    zero = heap.zeros_state(N_PE, device=x.device)

    def nbi():
        q = CommQueue("pe", zero)
        for k in range(K):              # all pending, mutually independent
            q.put_nbi(h, x[:, k * chunk:(k + 1) * chunk], RING,
                      offset=k * chunk)
        return q.quiet()["pipe"]        # ONE completion barrier

    def blocking():
        st = zero
        for k in range(K):              # each round fully ordered
            st = p2p.heap_put(st, h, x[:, k * chunk:(k + 1) * chunk], RING,
                              "pe", offset=k * chunk)
        return st["pipe"]

    return {"nbi": nbi, "blocking": blocking}[op]


def cell(op: str, stager: str, x: torch.Tensor, warmup: int,
         repeats: int) -> dict:
    """One (op, stager, dtype, size) cell: checked, then timed."""
    dev = x.device
    fn = make_op(op, x)
    before = symm_copy.LAUNCHES["copy_blocked"]
    with (p2p.staged_payloads(copy_stager) if stager == "copy"
          else contextlib.nullcontext()):
        out = fn()
        for _ in range(warmup - 1):
            fn()
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(repeats):
            fn()
        _sync(dev)
        dt = (time.perf_counter() - t0) / repeats
    launches = symm_copy.LAUNCHES["copy_blocked"] - before
    elems = x.shape[1]
    want = expected_launches(op, elems, x.dtype) * (warmup + repeats) \
        if stager == "copy" and dev.type == "cuda" else 0
    per_pe = elems * x.element_size()
    return {"op": op, "stager": stager,
            "dtype": str(x.dtype).removeprefix("torch."), "elems": elems, "bytes_per_pe": per_pe, "us": dt * 1e6,
            "gb_s_per_pe": per_pe / dt / 1e9,
            "ok": _same_bits(out, torch.roll(x, SHIFT[op], 0)),
            "launches": launches, "expected_launches": want,
            "out": out}


def inputs(elems: int, dtype, dev) -> torch.Tensor:
    """(8, elems): distinct values a PE, exact in every dtype."""
    x = torch.arange(N_PE * elems, device=dev) % 251
    return x.reshape(N_PE, elems).to(dtype)


def sweep(cfg, dev, stagers=STAGERS) -> list:
    """Every size x dtype x op of ``SWEEP_OPS`` x stager of ``cfg`` (a
    ``PoshMicroConfig``), then the pipeline cells; each row as ``cell``
    returns it, plus ``same_as_default`` under the copy stager (its
    output equals the default stager's bit for bit)."""
    rows = []
    pipe = K * min(PIPE_ELEMS, max(cfg.buffer_sizes))
    for name in cfg.dtypes:
        dtype = DTYPES[name]
        cases = [(op, e) for e in cfg.buffer_sizes for op in SWEEP_OPS]
        cases += [(op, pipe) for op in ("nbi", "blocking")]
        for i, (op, elems) in enumerate(cases):
            x = inputs(elems, dtype, dev)
            outs = {}
            for stager in stagers:
                r = cell(op, stager, x, cfg.warmup, cfg.repeats)
                r["pipeline"] = i >= len(cases) - 2
                outs[stager] = r.pop("out")
                if stager != "default" and "default" in outs:
                    r["same_as_default"] = _same_bits(outs[stager],
                                                      outs["default"])
                rows.append(r)
            del x, outs
    return rows


def failures(rows) -> list:
    """Rows whose output, stager agreement or launches disagree."""
    return [r for r in rows
            if not r["ok"] or not r.get("same_as_default", True)
            or r["launches"] != r["expected_launches"]]


def table(rows, stager: str) -> str:
    """The paper's Tables 1–2 for one stager: us a call, per-PE GB/s,
    and put / get over the local copy."""
    head = (f"{'dtype':>8} {'elems/PE':>9} {'put us':>9} {'get us':>9} "
            f"{'nbi us':>9} {'copy us':>9} {'put GB/s':>9} {'get GB/s':>9} "
            f"{'put/copy':>8} {'get/copy':>8}")
    lines = [f"stager {stager}:", head]
    by = {(r["dtype"], r["elems"], r["op"]): r for r in rows
          if r["stager"] == stager and not r["pipeline"]}
    for (dt, elems) in sorted({(d, e) for d, e, _ in by},
                              key=lambda k: (k[0], k[1])):
        c = {op: by[(dt, elems, op)] for op in SWEEP_OPS}
        lines.append(
            f"{dt:>8} {elems:>9} {c['put']['us']:>9.1f} "
            f"{c['get']['us']:>9.1f} {c['nbi']['us']:>9.1f} "
            f"{c['copy']['us']:>9.1f} {c['put']['gb_s_per_pe']:>9.3f} "
            f"{c['get']['gb_s_per_pe']:>9.3f} "
            f"{c['put']['us'] / c['copy']['us']:>8.2f} "
            f"{c['get']['us'] / c['copy']['us']:>8.2f}")
    for r in rows:
        if r["stager"] == stager and r["pipeline"]:
            lines.append(f"{r['dtype']:>8} {K} x {r['elems'] // K} puts via "
                         f"{r['op']:<9}: {r['us']:9.1f} us")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="posh-micro's smoke config (2 sizes, 2 repeats)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "plain versions)")
    ap.add_argument("--json", default=None, help="write the rows here")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    cfg = configs.get_smoke("posh-micro") if args.smoke \
        else configs.get("posh-micro")
    symm_copy.reset_launches()
    rows = sweep(cfg, dev)
    for stager in STAGERS:
        print(table(rows, stager))
    print("paper claim (§5.2): put/get ≈ local copy — overhead should be "
          "small and size-independent at large buffers.")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    bad = failures(rows)
    for r in bad:
        print(f"FAIL {r}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
