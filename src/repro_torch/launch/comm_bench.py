"""Communicator benchmark of the port on 8 PEs — the numbers behind the
dispatch table (counterpart of ``benchmarks/comm_microbench.py``).

    PYTHONPATH=src python -m repro_torch.launch.comm_bench [--out FILE]

One team of 8 PEs, every PE's shard on the leading axis of one tensor on
the card (``--device cpu`` runs the plain versions on the CPU, and only
when asked).  Rows, in ``BENCH_comm.json``'s schema (``op``, ``algo``,
``nbytes`` per PE, ``elems``, ``us_per_call``, ``bytes_per_s`` = per-PE
bytes / time), for float32 payloads of 256 B to 64 MiB per PE:

  * the schedule sweep: each collective under each of its algorithms
    (``core.collectives`` called directly, no stager);
  * backend rows (``algo = "backend:<name>"``): psum, all_gather,
    psum_scatter, all_to_all and pbroadcast through a communicator of
    each backend — xla, posh, and pallas, whose payloads the CUDA copy
    engine stages.  Before it is timed each (op, size) is run once per
    backend and checked: pallas equals posh bit for bit, posh equals
    xla (data movement exactly, sums within f32 rounding), and on the
    card the pallas call launched the copy kernel once per round whose
    per-PE payload reaches the copy engine's "stock" threshold
    (``staged_payload_bytes`` models each schedule's rounds);
  * copy-engine rows (``op = "symm_copy"``, ``algo`` = variant): the
    §4.4 variant sweep, 4 KiB to 256 MiB.

plus ``chosen`` (what the default dispatch table picks at each size) and
``tuned_thresholds`` (the crossovers these rows measure).  Times are
host wall clock per call over ``--reps`` calls ending in a
synchronize: what an eager caller waits for.  ``meta.device`` names the
card and its power limit.  Prints the JSON, or writes it to ``--out``;
it never writes the repo's ``BENCH_comm.json`` (the reference's CPU
rows).
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import time
from typing import Callable, Optional

import torch

from repro_torch import comm as C
from repro_torch.core import collectives as posh
from repro_torch.device import resolve
from repro_torch.kernels import ops
from repro_torch.kernels import symm_copy

N = 8
SIZES = [256, 4 << 10, 64 << 10, 1 << 20, 16 << 20, 64 << 20]
COPY_SIZES = [4 << 10, 64 << 10, 1 << 20, 16 << 20, 256 << 20]
COMM_OPS = ("psum", "all_gather", "psum_scatter", "all_to_all", "pbroadcast")
SUM_OPS = ("psum", "psum_scatter")       # reductions: compared to xla
                                         # within f32 rounding

# op -> (algorithms, stacked body)
SCHEDULES: dict[str, tuple[tuple[str, ...], Callable]] = {
    "psum": (("tree", "recursive_doubling", "ring", "xla"),
             lambda x, a: posh.allreduce(x, "sum", "pe", a)),
    "all_gather": (("recursive_doubling", "ring", "xla"),
                   lambda x, a: posh.fcollect(x, "pe", a)),
    "psum_scatter": (("ring", "xla"),
                     lambda x, a: posh.reduce_scatter(x, "sum", "pe", a)),
    "all_to_all": (("pairwise", "xla"),
                   lambda x, a: posh.alltoall(x.reshape(N, N, -1), "pe", a)),
    "pbroadcast": (("binomial", "linear", "xla"),
                   lambda x, a: posh.broadcast(x, 0, "pe", a)),
}


def comm_call(comm, op: str, x: torch.Tensor) -> torch.Tensor:
    """One communicator call of ``op`` on the stacked ``(N, elems)``."""
    if op == "psum":
        return comm.psum(x)
    if op == "all_gather":
        return comm.all_gather(x, axis=0)
    if op == "psum_scatter":
        return comm.psum_scatter(x, axis=0)
    if op == "all_to_all":
        return comm.all_to_all(x, split_axis=0, concat_axis=0)
    return comm.pbroadcast(x, 0)


def staged_payload_bytes(op: str, algo: str, n: int, elems: int,
                         itemsize: int) -> list[int]:
    """Per-PE payload bytes of each p2p round of ``op`` under ``algo``
    on a full team of ``n`` PEs with ``elems`` elements per PE: the
    schedules of ``core.collectives``, modelled from the paper's
    algorithms (a check on them, not a reading of them)."""
    b = elems * itemsize
    log = math.ceil(math.log2(n))
    if algo == "xla":
        return []
    if op in ("psum", "pmax"):
        if algo == "ring" or (algo == "recursive_doubling" and n & (n - 1)):
            return [-(-elems // n) * itemsize] * (2 * (n - 1))
        if algo == "tree":
            return [b] * (2 * log)           # binomial reduce + broadcast
        return [b] * log                     # recursive doubling
    if op == "all_gather":
        if algo == "recursive_doubling" and not n & (n - 1):
            return [b << k for k in range(log)]
        return [b] * (n - 1)
    if op in ("psum_scatter", "all_to_all"):
        return [b // n] * (n - 1)
    if op == "pbroadcast":
        return [b] * (log if algo.startswith("binomial") else n - 1)
    raise KeyError(op)


def expected_copy_launches(op, algo, n, elems, dtype) -> int:
    """Rounds whose payload the pallas stager sends to the kernel."""
    item = torch.empty((), dtype=dtype).element_size()
    return sum(1 for nb in staged_payload_bytes(op, algo, n, elems, item)
               if symm_copy.choose_variant(nb, dtype) != "stock")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timeit(fn: Callable, dev: torch.device, reps: int) -> float:
    """Seconds per call: ``reps`` calls ending in a synchronize, after
    two warm-up calls."""
    for _ in range(2):
        fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(dev)
    return (time.perf_counter() - t0) / reps


def _row(op, algo, nbytes, elems, dt):
    return {"op": op, "algo": algo, "nbytes": nbytes, "elems": elems,
            "us_per_call": dt * 1e6, "bytes_per_s": nbytes / dt}


def _input(nbytes: int, dev: torch.device, seed: int) -> torch.Tensor:
    elems = max(nbytes // 4, N)
    elems = (elems // N) * N                 # divisible for scatter/a2a
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((N, elems), generator=g, device=dev)


def _log(quiet: bool, msg: str) -> None:
    if not quiet:
        print(msg, flush=True)


def schedule_rows(dev, sizes, reps, quiet=False) -> list:
    rows = []
    for op, (algos, body) in SCHEDULES.items():
        for nbytes in sizes:
            x = _input(nbytes, dev, seed=nbytes)
            for algo in algos:
                dt = timeit(lambda: body(x, algo), dev, reps)
                rows.append(_row(op, algo, x[0].numel() * 4, x.shape[1], dt))
                _log(quiet, f"  {op:<13} {algo:<19} {x[0].numel() * 4:>9}B "
                     f"{dt * 1e6:>10.1f}us")
    return rows


def backend_rows(dev, sizes, reps, quiet=False) -> tuple[list, list]:
    """The backend matrix, each (op, size) checked before it is timed
    (see the module docstring); returns (rows, checks)."""
    comms = {b: C.make_communicator("pe", size=N, backend=b)
             for b in ("xla", "posh", "pallas")}
    rows, checks = [], []
    for op in COMM_OPS:
        for nbytes in sizes:
            x = _input(nbytes, dev, seed=nbytes + 1)
            elems = x.shape[1]
            outs = {}
            for b, comm in comms.items():
                comm.reset_stats()
                before = symm_copy.LAUNCHES["copy_blocked"]
                outs[b] = comm_call(comm, op, x)
                _sync(dev)
                if b == "pallas":
                    launches = symm_copy.LAUNCHES["copy_blocked"] - before
                    (algo,) = comm.stats()[op]["algos"]
            # the kernel runs on the card only (the CPU copy is the plain
            # version, which counts nothing)
            want = expected_copy_launches(op, algo, N, elems, x.dtype) \
                if dev.type == "cuda" else 0
            pallas_eq_posh = torch.equal(outs["pallas"], outs["posh"])
            if op in SUM_OPS:
                tol = 1e-5 * float(x.abs().max()) * N
                xla_ok = torch.allclose(outs["posh"], outs["xla"], rtol=1e-5,
                                        atol=tol)
            else:
                xla_ok = torch.equal(outs["posh"], outs["xla"])
            check = {"op": op, "nbytes": elems * 4, "algo": algo,
                     "pallas_eq_posh": pallas_eq_posh, "posh_vs_xla": xla_ok,
                     "copy_launches": launches, "expected_launches": want}
            checks.append(check)
            if not (pallas_eq_posh and xla_ok and launches == want):
                raise RuntimeError(f"comm check failed: {check}")
            del outs
            for b, comm in comms.items():
                dt = timeit(lambda: comm_call(comm, op, x), dev, reps)
                rows.append(_row(op, f"backend:{b}", elems * 4, elems, dt))
                _log(quiet, f"  {op:<13} backend:{b:<11} {elems * 4:>9}B "
                     f"{dt * 1e6:>10.1f}us")
    return rows, checks


def copy_rows(dev, sizes, reps, quiet=False) -> list:
    """The copy-engine variant sweep."""
    rows = []
    for nbytes in sizes:
        elems = nbytes // 4
        g = torch.Generator(device=dev).manual_seed(nbytes + 2)
        x = torch.randn(elems, generator=g, device=dev)
        for variant in ops.COPY_VARIANTS:
            dt = timeit(lambda: ops.symm_copy(x, variant), dev, reps)
            rows.append(_row("symm_copy", variant, nbytes, elems, dt))
            _log(quiet, f"  {'symm_copy':<13} {variant:<19} {nbytes:>9}B "
                 f"{dt * 1e6:>10.1f}us")
        del x
    return rows


def device_name(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if dev.type != "cuda":
        return "cpu"
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", str(dev.index or 0)],
                         capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def run(device=None, sizes=SIZES, copy_sizes=COPY_SIZES, reps: int = 10,
        quiet: bool = False) -> dict:
    """The whole benchmark on ``device`` (the card unless the CPU is
    asked for); returns the bench dict."""
    dev = resolve(device)
    results = schedule_rows(dev, sizes, reps, quiet)
    brows, checks = backend_rows(dev, sizes, reps, quiet)
    results += brows + copy_rows(dev, copy_sizes, reps, quiet)
    return assemble(dev, results, checks, sizes, copy_sizes, reps)


def assemble(dev, results, checks, sizes, copy_sizes, reps) -> dict:
    """The bench dict of measured ``results`` and ``checks``: adds
    ``chosen``, ``tuned_thresholds`` and ``meta``."""
    table = C.DispatchTable()
    chosen = [{"op": op, "nbytes": nb, "algo": table.choose(op, nb, N)}
              for op in COMM_OPS for nb in sizes]
    bench = {"results": results, "chosen": chosen, "checks": checks}
    tuned = C.DispatchTable.tuned_from_bench(bench)
    bench["tuned_thresholds"] = {
        "allreduce_small_bytes": tuned.allreduce_small_bytes,
        "allgather_small_bytes": tuned.allgather_small_bytes,
    }
    bench["meta"] = {
        "n_pe": N, "device": device_name(dev),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "dtype": "float32", "reps": reps, "sizes": list(sizes),
        "copy_sizes": list(copy_sizes),
        "timing": "host wall clock per call, synchronized",
        "backends": list(C.available_backends()),
        "copy_variants": list(ops.COPY_VARIANTS),
        "stock_threshold_bytes_f32": 8 * 128 * 4,
        "defaults": {"allreduce_small_bytes": table.allreduce_small_bytes,
                     "allgather_small_bytes": table.allgather_small_bytes},
    }
    return bench


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain versions)")
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)),
                    help="per-PE payload bytes, comma-separated")
    ap.add_argument("--copy-sizes", default=",".join(map(str, COPY_SIZES)))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=None, help="write the JSON here")
    args = ap.parse_args(argv)
    bench = run(args.device, [int(s) for s in args.sizes.split(",")],
                [int(s) for s in args.copy_sizes.split(",")], args.reps)
    text = json.dumps(bench, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"wrote {args.out}: {len(bench['results'])} rows; measured "
              f"thresholds {bench['tuned_thresholds']}", flush=True)
    else:
        print(text, flush=True)
    return bench


if __name__ == "__main__":
    main()
