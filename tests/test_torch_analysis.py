"""repro_torch.analysis against repro.analysis: the shmem checker and the
lint of the port.

* The checker: every sequence of ``tests/test_analysis.py`` (ww / wr /
  signal / amo races, raw signal words, handle lifetimes, Fact 1's
  offset symmetry, nested drains, the findings cap) replayed through the
  reference's CommQueue and heap (numpy, ``LocalTransport``) and the
  port's (torch, ``LocalTransport``), single process, no mesh: the same
  findings by rule and count, the same ``compare_heaps`` verdicts.
* The lint: the reference's corpus of true and false positives on the
  port's rules, the raw-collective rule restated for PyTorch
  (``torch.distributed`` and direct ``core.collectives`` calls outside
  ``repro_torch/comm|core``); ``src/repro_torch`` is clean; the CLI's
  exit codes.
* The pytest plugin ``repro_torch.analysis.pytest_arm``: one subprocess
  pytest over a temp file — a racy test fails (an error in its
  teardown) with the report written, a clean one and a ``shmem_racy``
  one pass.
"""
import contextlib
import json
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.analysis import shmemcheck as jcheck
from repro.core.heap import SymHandle as JSymHandle
from repro_torch import core as tcore
from repro_torch.analysis import lint as tlint
from repro_torch.analysis import shmemcheck as tcheck
from repro_torch.core import heap as theap
from repro_torch.core import ordering as tordering
from repro_torch.core.heap import SymHandle as TSymHandle

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
PKG = os.path.join(SRC, "repro_torch")
N_PE = 3


def _kit(port: bool):
    """One side's constructors: queues, heaps, handles and arrays."""
    f32, i64 = (torch.float32, torch.int64) if port else \
        (np.dtype(np.float32), np.dtype(np.int64))
    Sym = TSymHandle if port else JSymHandle
    core = tcore if port else jcore

    def zeros(shape, dt=f32):
        return torch.zeros(shape, dtype=dt) if port else np.zeros(shape, dt)

    def full(shape, v, dt=f32):
        return torch.full(shape, v, dtype=dt) if port \
            else np.full(shape, v, dt)

    k = types.SimpleNamespace(
        core=core, check=tcheck if port else jcheck, f32=f32, i64=i64,
        zeros=zeros, full=full,
        HANDLE=Sym("buf", (8,), f32, 0, 32),
        SIG=Sym("sig", (4,), i64, 32, 32))

    def queue(state=None, seed=7):
        state = state if state is not None else {"buf": zeros((N_PE, 8))}
        return core.CommQueue("pe", state,
                              transport=core.LocalTransport(N_PE),
                              delivery_seed=seed)

    def sig_queue(seed=7):
        return queue({"buf": zeros((N_PE, 8)),
                      "sig": zeros((N_PE, 4), i64)}, seed)

    k.queue, k.sig_queue = queue, sig_queue
    k.payload = lambda v, rows=1: full((N_PE, rows), float(v))
    k.heap = lambda: core.SymmetricHeap(("pe",), capacity_bytes=1 << 20)
    return k


@contextlib.contextmanager
def fresh(k):
    """A private checker installed into one side's hooks."""
    was = k.check.is_enabled()
    chk = k.check.ShmemChecker()
    k.check._install(chk)
    try:
        yield chk
    finally:
        k.check._install(None)
        if was:
            k.check.enable()


# ======================================================================
# the sequences of tests/test_analysis.py, each returning what it found
# ======================================================================
def s_ww_race(k, chk):
    q = k.queue()
    q.put_nbi(k.HANDLE, k.payload(1.0, 3), [(0, 1)], offset=0)
    q.put_nbi(k.HANDLE, k.payload(2.0, 3), [(0, 1)], offset=2)
    q.quiet()


def s_fence_separated(k, chk):
    q = k.queue()
    q.put_nbi(k.HANDLE, k.payload(1.0, 3), [(0, 1)], offset=0)
    q.fence()
    q.put_nbi(k.HANDLE, k.payload(2.0, 3), [(0, 1)], offset=2)
    q.quiet()


def s_quiet_separated(k, chk):
    q = k.queue()
    q.put_nbi(k.HANDLE, k.payload(1.0, 3), [(0, 1)], offset=0)
    q.quiet()
    q.put_nbi(k.HANDLE, k.payload(2.0, 3), [(0, 1)], offset=0)
    q.quiet()


def s_disjoint(k, chk):
    q = k.queue()
    q.put_nbi(k.HANDLE, k.payload(1.0, 2), [(0, 1)], offset=0)
    q.put_nbi(k.HANDLE, k.payload(2.0, 2), [(0, 1)], offset=2)
    q.put_nbi(k.HANDLE, k.payload(3.0, 2), [(0, 2)], offset=0)
    q.quiet()


def s_per_dst_fence(k, chk):
    q = k.queue()
    q.put_nbi(k.HANDLE, k.payload(1.0, 2), [(0, 1), (0, 2)], offset=0)
    q.fence(dst=1)
    q.put_nbi(k.HANDLE, k.payload(2.0, 2), [(0, 2)], offset=1)
    q.quiet()


def s_state_read_before_drain(k, chk):
    q = k.queue()
    q.put_nbi(k.HANDLE, k.payload(4.0), [(0, 1)])
    _ = q.state
    q.quiet()


def s_state_read_after_drain(k, chk):
    q = k.queue()
    q.put_nbi(k.HANDLE, k.payload(4.0), [(0, 1)])
    q.quiet()
    _ = q.state


def s_put_through_freed(k, chk):
    heap = k.heap()
    h = heap.alloc("x", (8,), np.float32)
    q = k.queue({"x": k.zeros((N_PE, 8))})
    heap.free(h)
    q.put_nbi(h, k.payload(1.0), [(0, 1)])
    q.quiet()


def s_live_roundtrip(k, chk):
    heap = k.heap()
    h = heap.alloc("x", (8,), np.float32)
    q = k.queue({"x": k.zeros((N_PE, 8))})
    q.put_nbi(h, k.payload(1.0), [(0, 1)])
    q.quiet()
    heap.free(h)


def s_stale_after_realloc(k, chk):
    heap = k.heap()
    old = heap.alloc("x", (8,), np.float32)
    heap.alloc("blocker", (8,), np.float32)
    new = heap.realloc("x", (4096,))
    assert new.offset != old.offset
    q = k.queue({"x": k.zeros((N_PE, 8))})
    q.put_nbi(old, k.payload(1.0), [(0, 1)])
    q.quiet()


def s_double_free(k, chk):
    heap = k.heap()
    heap.alloc("x", (8,), np.float32)
    heap.free("x")
    with pytest.raises(KeyError):
        heap.free("x")


def s_free_never_allocated(k, chk):
    with pytest.raises(KeyError):
        k.heap().free("ghost")


def s_offset_asymmetry(k, chk):
    ha, hb = k.heap(), k.heap()
    ha.alloc("w", (8,), np.float32)
    hb.alloc("w", (16,), np.float32)
    return [f.rule for f in chk.compare_heaps(ha, hb)]


def s_symmetric_heaps(k, chk):
    heaps = [k.heap() for _ in range(3)]
    for h in heaps:
        h.alloc("w", (8,), np.float32)
        h.alloc("kv", (4, 2), np.int32)
    return [f.rule for f in chk.compare_heaps(*heaps)]


def s_alloc_count_divergence(k, chk):
    ha, hb = k.heap(), k.heap()
    for h in (ha, hb):
        h.alloc("w", (8,), np.float32)
    hb.alloc("extra", (8,), np.float32)
    bad = chk.compare_heaps(ha, hb)
    assert "extra" in bad[0].message
    return [f.rule for f in bad]


def s_drain_callback_fence(k, chk):
    q = k.queue()
    q.allreduce_nbi(k.full((3,), 1.0), lambda x: (q.fence(), x)[1])
    q.quiet()


def s_plain_reduce_callback(k, chk):
    q = k.queue()
    r = q.allreduce_nbi(k.full((3,), 1.0), lambda x: x * 2)
    q.quiet()
    return [float(v) for v in r.value()]


def s_findings_cap(k, chk):
    q = k.queue()
    for _ in range(k.check.MAX_FINDINGS + 50):
        _ = q.state
        q.put_nbi(k.HANDLE, k.payload(1.0, 8), [(0, 1)], offset=0)
    q.quiet()
    return chk.dropped


def s_signal_read_before_wait(k, chk):
    q = k.sig_queue()
    q.put_signal_nbi(k.HANDLE, k.payload(5.0), [(0, 1)], k.SIG, 1,
                     offset=2, sig_offset=0)
    _ = q.state
    q.signal_wait_until(k.SIG, "eq", 1, sig_offset=0, pe=1)
    assert "signal_wait_until" in chk.report()[0].message


def s_signal_read_after_wait(k, chk):
    q = k.sig_queue()
    q.put_signal_nbi(k.HANDLE, k.payload(5.0), [(0, 1)], k.SIG, 1,
                     offset=2, sig_offset=0)
    q.signal_wait_until(k.SIG, "eq", 1, sig_offset=0, pe=1)
    _ = q.state


def s_wait_retires_exactly(k, chk):
    q = k.sig_queue()
    q.put_signal_nbi(k.HANDLE, k.payload(1.0), [(0, 1)], k.SIG, 1,
                     offset=0, sig_offset=0)
    q.put_signal_nbi(k.HANDLE, k.payload(2.0), [(0, 1)], k.SIG, 2,
                     offset=4, sig_offset=1)
    q.signal_wait_until(k.SIG, "eq", 1, sig_offset=0, pe=1)
    _ = q.state
    q.signal_wait_until(k.SIG, "eq", 2, sig_offset=1, pe=1)
    return all("'sig'+1" in f.message for f in chk.report())


def s_raw_signal(k, chk):
    q = k.sig_queue()
    q.put_signal_nbi(k.HANDLE, k.payload(1.0), [(0, 1)], k.SIG, 1,
                     offset=0, sig_offset=2)
    q.signal_wait_until(k.SIG, "eq", 1, sig_offset=2, pe=1)
    q.put_nbi(k.SIG, k.full((N_PE, 1), 1, k.i64), [(0, 1)], offset=2)
    q.quiet()


def s_raw_signal_other_offset(k, chk):
    q = k.sig_queue()
    q.put_signal_nbi(k.HANDLE, k.payload(1.0), [(0, 1)], k.SIG, 1,
                     offset=0, sig_offset=2)
    q.signal_wait_until(k.SIG, "eq", 1, sig_offset=2, pe=1)
    q.put_nbi(k.SIG, k.full((N_PE, 1), 1, k.i64), [(0, 1)], offset=0)
    q.quiet()


def s_multi_page_ticket(k, chk):
    q = k.sig_queue()
    for i in range(3):
        q.put_signal_nbi(k.HANDLE, k.payload(float(i)), [(0, 1)], k.SIG, 7,
                         offset=i, sig_offset=3)
    q.signal_wait_until(k.SIG, "eq", 7, sig_offset=3, pe=1)
    q.put_signal_nbi(k.HANDLE, k.payload(9.0), [(0, 2)], k.SIG, 8,
                     offset=0, sig_offset=3)
    q.fence()
    _ = q.state


def s_amo_plain_put_on_word(k, chk):
    q = k.sig_queue()
    q.amo_nbi(k.SIG, "fadd", [(0, 1)], value=1, offset=2)
    q.amo_wait(k.SIG, offset=2)
    q.put_nbi(k.SIG, k.full((N_PE, 1), 1, k.i64), [(0, 1)], offset=2)
    q.quiet()
    assert "amo_nbi" in chk.report()[0].message


def s_amo_over_pending_put(k, chk):
    q = k.sig_queue()
    q.put_nbi(k.SIG, k.full((N_PE, 1), 1, k.i64), [(0, 1)], offset=2)
    q.amo_nbi(k.SIG, "fadd", [(0, 1)], value=1, offset=2)
    q.amo_wait(k.SIG, offset=2)
    q.quiet()
    return chk.report()[0].other_loc is not None


def s_amo_plain_put_other_word(k, chk):
    q = k.sig_queue()
    q.amo_nbi(k.SIG, "fadd", [(0, 1)], value=1, offset=2)
    q.amo_wait(k.SIG, offset=2)
    q.put_nbi(k.SIG, k.full((N_PE, 1), 1, k.i64), [(0, 1)], offset=0)
    q.quiet()


def s_concurrent_amos(k, chk):
    q = k.sig_queue()
    for src in range(3):
        q.amo_nbi(k.SIG, "fadd", [(src, 1)], value=1, offset=2)
    q.amo_wait(k.SIG, offset=2)


def s_amo_wait_retires_word(k, chk):
    q = k.sig_queue()
    q.amo_nbi(k.SIG, "fadd", [(0, 1)], value=1, offset=2)
    q.amo_nbi(k.SIG, "fadd", [(0, 1)], value=1, offset=3)
    q.amo_wait(k.SIG, offset=2)
    mid = [w.amo_key for w in chk._pending[id(q)]]
    q.amo_wait(k.SIG, offset=3)
    return mid, chk._pending[id(q)] == []


# name -> the rules the reference's test asserts (None: compared only)
SEQUENCES = {
    "ww_race": (s_ww_race, ["ww-race"]),
    "fence_separated": (s_fence_separated, []),
    "quiet_separated": (s_quiet_separated, []),
    "disjoint": (s_disjoint, []),
    "per_dst_fence": (s_per_dst_fence, ["ww-race"]),
    "state_read_before_drain": (s_state_read_before_drain, ["wr-race"]),
    "state_read_after_drain": (s_state_read_after_drain, []),
    "put_through_freed": (s_put_through_freed, None),
    "live_roundtrip": (s_live_roundtrip, []),
    "stale_after_realloc": (s_stale_after_realloc, None),
    "double_free": (s_double_free, None),
    "free_never_allocated": (s_free_never_allocated, []),
    "offset_asymmetry": (s_offset_asymmetry, ["offset-asymmetry"]),
    "symmetric_heaps": (s_symmetric_heaps, []),
    "alloc_count_divergence": (s_alloc_count_divergence,
                               ["offset-asymmetry"]),
    "drain_callback_fence": (s_drain_callback_fence, None),
    "plain_reduce_callback": (s_plain_reduce_callback, []),
    "findings_cap": (s_findings_cap, None),
    "signal_read_before_wait": (s_signal_read_before_wait,
                                ["signal-race", "signal-race"]),
    "signal_read_after_wait": (s_signal_read_after_wait, []),
    "wait_retires_exactly": (s_wait_retires_exactly,
                             ["signal-race", "signal-race"]),
    "raw_signal": (s_raw_signal, None),
    "raw_signal_other_offset": (s_raw_signal_other_offset, []),
    "multi_page_ticket": (s_multi_page_ticket, []),
    "amo_plain_put_on_word": (s_amo_plain_put_on_word, None),
    "amo_over_pending_put": (s_amo_over_pending_put, ["amo-race"]),
    "amo_plain_put_other_word": (s_amo_plain_put_other_word, []),
    "concurrent_amos": (s_concurrent_amos, []),
    "amo_wait_retires_word": (s_amo_wait_retires_word, []),
}


def _run(port: bool, seq):
    k = _kit(port)
    with fresh(k) as chk:
        extra = seq(k, chk)
    return [f.rule for f in chk.report()], extra


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_checker_findings_match_reference(name):
    seq, want = SEQUENCES[name]
    got, got_extra = _run(True, seq)
    ref, ref_extra = _run(False, seq)
    assert got == ref, (got, ref)
    assert got_extra == ref_extra
    if want is not None:
        assert got == want
    # the rules the reference's test looks for by membership
    member = {"put_through_freed": "use-after-free",
              "stale_after_realloc": "stale-handle",
              "double_free": "double-free",
              "drain_callback_fence": "nested-drain",
              "raw_signal": "raw-signal",
              "amo_plain_put_on_word": "amo-race"}
    if name in member:
        assert member[name] in got
    if name == "findings_cap":
        assert len(got) == tcheck.MAX_FINDINGS and got_extra > 0


def test_checker_locations_point_at_the_caller():
    """A finding names the caller's line (outside repro_torch/core and
    analysis) for both conflicting events, as the reference's."""
    k = _kit(True)
    with fresh(k) as chk:
        s_ww_race(k, chk)
    f = chk.report()[0]
    assert "test_torch_analysis.py" in f.loc
    assert "test_torch_analysis.py" in f.other_loc
    assert "PE 1" in f.message


def test_hooks_cost_nothing_when_off_and_suspend_restores():
    """Off, the hook slots are None (one load and an is-None test a
    site); ``suspended`` uninstalls and restores; ``enable`` installs
    one checker into both core modules; the checker sees CUDA-free
    bookkeeping only, so CPU tensors exercise every hook."""
    tcheck.disable()
    assert tordering._checker is None and theap._checker is None
    chk = tcheck.enable()
    try:
        assert tordering._checker is chk and theap._checker is chk
        chk.reset()
        k = _kit(True)
        q = k.queue()
        with tcheck.suspended():
            assert not tcheck.is_enabled()
            s_ww_race(k, chk)
        assert tcheck.is_enabled() and chk.report() == []
        s_ww_race(k, chk)
        assert [f.rule for f in tcheck.report()] == ["ww-race"]
        assert tcheck.compare_heaps(k.heap(), k.heap()) == []
        del q
    finally:
        tcheck.reset()
        tcheck.disable()
    assert tcheck.report() == []


# ======================================================================
# the lint corpus, restated for the port
# ======================================================================
_NBI = {
    "nbi_without_drain": ("""
        def leak(q, h, x, pairs):
            q.put_nbi(h, x, pairs)
            return q.state
    """, ["nbi-drain"]),
    "nbi_with_quiet": ("""
        def ok(q, h, x, pairs):
            q.put_nbi(h, x, pairs)
            return q.quiet()
    """, []),
    "nbi_in_loop_drained_after": ("""
        def ok(q, h, pages, pairs):
            for i, x in enumerate(pages):
                q.put_nbi(h, x, pairs, offset=i)
            q.quiet()
    """, []),
    "branch_missing_drain": ("""
        def half(q, h, x, pairs, flush):
            q.put_nbi(h, x, pairs)
            if flush:
                q.quiet()
            return q.state
    """, ["nbi-drain"]),
    "both_branches_drained": ("""
        def ok(q, h, x, pairs, last):
            q.put_nbi(h, x, pairs)
            if last:
                q.quiet()
            else:
                q.fence()
            return q.state
    """, []),
    "deferred_on_call": ("""
        def pipeline_issue(q, h, x, pairs):
            return q.put_nbi(h, x, pairs)  # shmem: deferred-drain
    """, []),
    "deferred_on_def": ("""
        def pipeline_issue(q, h, x, pairs):  # shmem: deferred-drain
            q.put_nbi(h, x, pairs)
            q.put_nbi(h, x, pairs, offset=1)
    """, []),
    "raise_is_accepted_exit": ("""
        def ok(q, h, x, pairs):
            q.put_nbi(h, x, pairs)
            if x is None:
                raise ValueError("bad payload")
            q.quiet()
    """, []),
    "handle_after_free": ("""
        def leak(heap, q, x, pairs):
            h = heap.alloc("tmp", (8,), "float32")
            heap.free(h)
            q.put_nbi(h, x, pairs)  # shmem: deferred-drain
    """, ["handle-after-free"]),
    "handle_rebound_after_free": ("""
        def ok(heap, q, x, pairs):
            h = heap.alloc("tmp", (8,), "float32")
            heap.free(h)
            h = heap.alloc("tmp", (16,), "float32")
            q.put_nbi(h, x, pairs)
            q.quiet()
    """, []),
    "drain_in_callback": ("""
        def bad(q, g):
            r = q.allreduce_nbi(g, lambda x: (q.quiet(), x)[1])
            q.quiet()
            return r
    """, ["drain-callback"]),
    "plain_callback": ("""
        def ok(q, g, comm):
            r = q.allreduce_nbi(g, comm.psum)
            q.quiet()
            return r
    """, []),
    "put_signal_drained_by_wait": ("""
        def handoff(q, h, x, pairs, sig):
            q.put_signal_nbi(h, x, pairs, sig, 1, sig_offset=0)
            q.signal_wait_until(sig, "eq", 1, sig_offset=0, pe=1)
            return q.state
    """, []),
    "put_signal_without_wait": ("""
        def leak(q, h, x, pairs, sig):
            q.put_signal_nbi(h, x, pairs, sig, 1, sig_offset=0)
            return q.state
    """, ["nbi-drain"]),
    "put_signal_deferred": ("""
        def issue(q, h, x, pairs, sig, t):
            q.put_signal_nbi(  # shmem: deferred-drain
                h, x, pairs, sig, t + 1, sig_offset=0)
    """, []),
    "signal_wait_in_callback": ("""
        def bad(q, g, sig):
            r = q.allreduce_nbi(
                g, lambda x: (q.signal_wait_until(sig, "eq", 1), x)[1])
            q.quiet()
            return r
    """, ["drain-callback"]),
    "amo_drained_by_amo_wait": ("""
        def bump(q, h, pairs):
            q.amo_nbi(h, "fadd", pairs, value=1, offset=0)
            q.amo_wait(h, offset=0)
            return q.state
    """, []),
    "amo_without_drain": ("""
        def leak(q, h, pairs):
            q.amo_nbi(h, "fadd", pairs, value=1, offset=0)
            return q.state
    """, ["nbi-drain"]),
    "amo_wait_in_callback": ("""
        def bad(q, g, h):
            r = q.allreduce_nbi(
                g, lambda x: (q.amo_wait(h, offset=0), x)[1])
            q.quiet()
            return r
    """, ["drain-callback"]),
}

# the raw-collective rule restated: (source, path, rules)
_RAW = {
    "dist_alias_collective": ("""
        import torch.distributed as dist

        def reduce_me(x):
            dist.all_reduce(x)
            return x
    """, "repro_torch/serve/fixture.py", ["raw-collective"]),
    "dist_dotted_collective": ("""
        import torch

        def reduce_me(x):
            torch.distributed.broadcast(x, 0)
    """, "repro_torch/models/fixture.py", ["raw-collective"]),
    "dist_from_import": ("""
        from torch.distributed import all_gather_into_tensor as ag

        def gather(out, x):
            ag(out, x)
    """, "repro_torch/train/fixture.py", ["raw-collective"]),
    "dist_rank_query_is_legal": ("""
        import torch.distributed as dist

        def me():
            return dist.get_rank(), dist.get_world_size()
    """, "repro_torch/serve/fixture.py", []),
    "core_collectives_module": ("""
        from repro_torch.core import collectives as posh

        def reduce_me(x):
            return posh.psum_ring(x, "model")
    """, "repro_torch/models/fixture.py", ["raw-collective"]),
    "core_collectives_relative": ("""
        from ..core.collectives import psum_tree

        def reduce_me(x):
            return psum_tree(x, "model")
    """, "repro_torch/train/fixture.py", ["raw-collective"]),
    "core_reexport": ("""
        from repro_torch.core import allreduce

        def reduce_me(x):
            return allreduce(x, "model")
    """, "repro_torch/serve/fixture.py", ["raw-collective"]),
    "allowed_in_comm": ("""
        import torch.distributed as dist
        from ..core import collectives as C

        def impl(x):
            dist.all_reduce(x)
            return C.psum_ring(x, "model")
    """, "repro_torch/comm/communicator.py", []),
    "allowed_in_core": ("""
        from .collectives import psum_tree

        def impl(x):
            return psum_tree(x, "model")
    """, "repro_torch/core/atomics.py", []),
    "comm_bench_exempt": ("""
        from repro_torch.core import collectives as posh

        def sweep(x):
            return posh.psum_ring(x, "pe")
    """, "repro_torch/launch/comm_bench.py", []),
    "communicator_is_legal": ("""
        def reduce_me(ctx, x):
            return ctx.tp_comm.psum(x)
    """, "repro_torch/models/fixture.py", []),
}


@pytest.mark.parametrize("name", sorted(_NBI) + sorted(_RAW))
def test_lint_corpus(name):
    if name in _NBI:
        src, want = _NBI[name]
        path = "repro_torch/serve/fixture.py"
    else:
        src, path, want = _RAW[name]
    errs = tlint.lint_source(textwrap.dedent(src), path, path)
    assert [e.rule for e in errs] == want, [str(e) for e in errs]


def test_raw_collective_exemptions_carry_their_reason():
    """The allow-list names each file with why it calls the schedules
    directly; the rule is not weakened for any other file of launch/."""
    assert all(len(why) > 40 for why in tlint.RAW_COLLECTIVE_EXEMPT.values())
    src = textwrap.dedent(_RAW["comm_bench_exempt"][0])
    assert [e.rule for e in tlint.lint_source(
        src, "x.py", "repro_torch/launch/serve.py")] == ["raw-collective"]


def test_port_tree_is_lint_clean():
    errs = tlint.lint_paths([PKG])
    assert errs == [], "\n".join(str(e) for e in errs)


def test_lint_cli_exit_codes(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC)
    cmd = [sys.executable, "-m", "repro_torch.analysis.lint"]
    r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                       cwd=ROOT, timeout=300)
    assert r.returncode == 0 and "SHMEMLINT_PASS" in r.stdout, r.stderr
    assert "RuntimeWarning" not in r.stderr
    bad = tmp_path / "bad.py"
    bad.write_text("def f(q, h, x, p):\n    q.put_nbi(h, x, p)\n")
    r = subprocess.run(cmd + [str(bad)], capture_output=True, text=True,
                       env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 1
    lines = r.stdout.strip().splitlines()
    assert lines[-1] == "SHMEMLINT_FAIL findings=1"
    assert lines[0].startswith(f"{bad}:2: [nbi-drain]")


# ======================================================================
# the pytest plugin
# ======================================================================
_PLUGIN_TESTS = '''
import pytest
import torch
from repro_torch.core import CommQueue, LocalTransport
from repro_torch.core.heap import SymHandle

H = SymHandle("buf", (8,), torch.float32, 0, 32)


def _race(q):
    q.put_nbi(H, torch.ones(2, 3), [(0, 1)], offset=0)
    q.put_nbi(H, torch.ones(2, 3), [(0, 1)], offset=1)
    q.quiet()


def _q():
    return CommQueue("pe", {"buf": torch.zeros(2, 8)},
                     transport=LocalTransport(2))


def test_racy():
    _race(_q())


def test_clean():
    q = _q()
    q.put_nbi(H, torch.ones(2, 3), [(0, 1)], offset=0)
    q.quiet()


@pytest.mark.shmem_racy
def test_racy_on_purpose():
    _race(_q())
'''


def test_pytest_arm_fails_the_racy_test_and_writes_the_report(tmp_path):
    (tmp_path / "test_plugin_cases.py").write_text(_PLUGIN_TESTS)
    (tmp_path / "conftest.py").write_text(
        "def pytest_configure(config):\n"
        "    config.addinivalue_line('markers', 'shmem_racy: racy')\n")
    report = tmp_path / "report.json"
    env = dict(os.environ, PYTHONPATH=SRC, REPRO_SHMEMCHECK="1",
               REPRO_SHMEMCHECK_REPORT=str(report))
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "repro_torch.analysis.pytest_arm", "-rA",
         str(tmp_path / "test_plugin_cases.py")],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    out = r.stdout
    assert r.returncode == 1, out + r.stderr
    assert "3 passed, 1 error" in out, out
    assert "ERROR at teardown of test_racy ___" in out, out
    assert "shmemcheck: 1 memory-model finding(s):" in out
    assert "ERROR test_plugin_cases.py::test_racy - " in out
    assert out.count("ERROR test_plugin_cases.py") == 1
    data = json.loads(report.read_text())
    assert data["count"] == 1
    assert data["findings"][0]["rule"] == "ww-race"
    assert data["findings"][0]["test"].endswith("::test_racy")
