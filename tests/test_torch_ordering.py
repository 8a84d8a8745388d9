"""repro_torch's CommQueue (the §3.2 ordered pipeline) against the JAX
reference's, in process, with no mesh.

The reference's queue runs over its numpy ``LocalTransport``; the port's
over its torch ``LocalTransport`` (and, in the last tests, its stacked
``PermuteTransport``).  The same random issue sequences — the
generators of ``tests/test_ordering.py``: puts, per-destination and
global fences, put-with-signals with a mid-stream
``signal_wait_until``, AMOs drained word by word with ``amo_wait`` —
replayed under delivery seeds None, 0, 1, 7 must give EQUAL states,
equal fetched values and equal ``stats()``: the port shuffles each
drain with ``random.Random(delivery_seed)`` on the same list, so a seed
names the same delivery order on both sides.  The port's queue is also
held to the maximal-write oracle of ``tests/test_ordering.py`` directly,
at a reduced example count.  All comparisons are exact.
"""
import random

import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.core.heap import SymHandle as JSymHandle
from repro_torch import core as tcore
from repro_torch.core.heap import SymHandle as TSymHandle
from test_ordering import (N_CTR, N_PE, N_SIG, OBJ_LEN, SEEDS,
                           _as_put_events, _linearizable, gen_amo_sequence,
                           gen_sequence, gen_signal_sequence,
                           oracle_candidates)

torch.set_num_threads(2)

# the same symmetric objects on both sides (test_ordering's offsets)
J = {"buf": JSymHandle("buf", (OBJ_LEN,), np.dtype(np.float32), 0,
                       OBJ_LEN * 4),
     "sig": JSymHandle("sig", (N_SIG,), np.dtype(np.int64), 256, N_SIG * 8),
     "ctr": JSymHandle("ctr", (N_CTR,), np.dtype(np.int64), 512, N_CTR * 8)}
T = {"buf": TSymHandle("buf", (OBJ_LEN,), torch.float32, 0, OBJ_LEN * 4),
     "sig": TSymHandle("sig", (N_SIG,), torch.int64, 256, N_SIG * 8),
     "ctr": TSymHandle("ctr", (N_CTR,), torch.int64, 512, N_CTR * 8)}


class _Side:
    """One implementation (the reference's numpy queue or the port's
    torch queue) behind one replay driver."""

    def __init__(self, port: bool, seed, transport="local"):
        self.port = port
        self.h = T if port else J
        state = {"buf": np.zeros((N_PE, OBJ_LEN), np.float32),
                 "sig": np.zeros((N_PE, N_SIG), np.int64),
                 "ctr": np.zeros((N_PE, N_CTR), np.int64)}
        if port:
            state = {k: torch.from_numpy(v) for k, v in state.items()}
            tr = tcore.LocalTransport(N_PE) if transport == "local" \
                else tcore.PermuteTransport()
            self.q = tcore.CommQueue("pe", state, transport=tr,
                                     delivery_seed=seed)
        else:
            self.q = jcore.CommQueue("pe", state,
                                     transport=jcore.LocalTransport(N_PE),
                                     delivery_seed=seed)

    def arr(self, a):
        return torch.from_numpy(a) if self.port else a

    def state(self):
        return {k: np.asarray(v) for k, v in self.q.state.items()}


def _payload(pairs, values, rows):
    data = np.zeros((N_PE, rows), np.float32)
    for s, _ in pairs:
        data[s] = values[s] + np.arange(rows, dtype=np.float32) / 16.0
    return data


def _replay(side: _Side, events, wait_sig=True):
    """Issue ``events`` (put / fence / putsig / amo); one mid-stream
    signal_wait_until on the first guarded word (as check_signal_sequence
    does), amo_wait on every counter word, then quiet.  Returns the
    observable history: states after the wait and at the end, fetched
    AMO values, stats."""
    q, h = side.q, side.h
    hist = {}
    amos = []
    first_word = None
    for e in events:
        if e[0] == "put":
            _, pairs, offset, rows, values = e
            raw = _payload(pairs, values, rows)
            q.put_nbi(h["buf"], side.arr(raw), pairs, offset=offset)
            raw.fill(-999.0)      # local completion (torch shares raw)
        elif e[0] == "fence":
            q.fence(e[1])
        elif e[0] == "putsig":
            _, pairs, off, values, word = e
            raw = _payload(pairs, values, 1)
            q.put_signal_nbi(h["buf"], side.arr(raw), pairs, h["sig"], 1,
                             offset=off, sig_offset=word)
            raw.fill(-999.0)
            if first_word is None:
                first_word = (word, pairs[0][1])
        else:
            _, op, pair, word, value, cond = e
            amos.append(q.amo_nbi(h["ctr"], op, [pair], value=value,
                                  cond=cond, offset=word))
    if wait_sig and first_word is not None:
        word, pe = first_word
        q.signal_wait_until(h["sig"], "ne", 0, sig_offset=word, pe=pe)
        hist["after_wait"] = side.state()
    for word in range(N_CTR):
        q.amo_wait(h["ctr"], offset=word)
    hist["fetched"] = [int(r.value()) for r in amos]
    q.quiet()
    hist["final"] = side.state()
    hist["stats"] = q.stats()
    assert q.pending_ops() == 0
    return hist


def _assert_same(a, b, what):
    assert a.keys() == b.keys(), what
    for k in a:
        if k in ("after_wait", "final"):
            for name in a[k]:
                np.testing.assert_array_equal(a[k][name], b[k][name],
                                              err_msg=f"{what} {k} {name}")
        else:
            assert a[k] == b[k], (what, k, a[k], b[k])


GENS = {"put": (gen_sequence, 0), "signal": (gen_signal_sequence, 7000),
        "amo": (gen_amo_sequence, 9000)}


@pytest.mark.parametrize("chunk", range(3))
@pytest.mark.parametrize("kind", sorted(GENS))
def test_queue_matches_reference_under_every_seed(kind, chunk):
    gen, base = GENS[kind]
    for i in range(10):
        events = gen(random.Random(base + chunk * 10 + i))
        for seed in SEEDS:
            want = _replay(_Side(False, seed), events)
            got = _replay(_Side(True, seed), events)
            _assert_same(got, want, f"{kind} seq {chunk * 10 + i} seed {seed}")


@pytest.mark.parametrize("chunk", range(3))
def test_port_queue_meets_the_maximal_write_oracle(chunk):
    """The property of ``tests/test_ordering.py`` on the port's queue:
    every final value is one the model allows, AMO histories are
    linearizable, and totally ordered locations are seed-invariant."""
    for i in range(15):
        events = gen_amo_sequence(random.Random(11000 + chunk * 15 + i)) \
            + _as_put_events(gen_signal_sequence(
                random.Random(12000 + chunk * 15 + i)))
        puts = [e for e in events if e[0] in ("put", "fence")]
        cands = oracle_candidates(puts)
        finals = {}
        for seed in SEEDS:
            side = _Side(True, seed)
            hist = _replay(side, events, wait_sig=False)
            buf, ctr = hist["final"]["buf"], hist["final"]["ctr"]
            finals[seed] = buf
            for d in range(N_PE):
                for elem in range(OBJ_LEN):
                    allowed = cands.get((d, elem))
                    got = float(buf[d, elem])
                    assert (got == 0.0) if allowed is None \
                        else got in allowed, (seed, d, elem, got, allowed)
            cells: dict = {}
            amo_ev = [e for e in events if e[0] == "amo"]
            for e, old in zip(amo_ev, hist["fetched"]):
                _, op, (_, owner), word, value, cond = e
                cells.setdefault((owner, word), []).append(
                    (op, value, cond, old))
            for (owner, word), h in cells.items():
                assert _linearizable(h, int(ctr[owner, word])), (seed, h)
        for (d, elem), allowed in cands.items():
            if len(allowed) == 1:
                assert len({float(finals[s][d, elem]) for s in SEEDS}) == 1


def test_gets_reductions_and_phases_match_reference():
    """get_nbi (default and explicit size), allreduce_nbi in issue
    order, per-destination fences, coalescing and phase windows: equal
    values and stats on both sides."""
    out = {}
    for port in (False, True):
        side = _Side(port, seed=3)
        q, h = side.q, side.h
        with q.phase("stream"):
            for k in range(3):                       # contiguous: coalesce
                q.put_nbi(h["buf"], side.arr(np.full((N_PE, 1), k + 1.0,
                                                     np.float32)),
                          [(0, 1), (2, 0)], offset=k)
            q.fence(1)
            q.put_nbi(h["buf"], side.arr(np.full((N_PE, 2), 9.0, np.float32)),
                      [(1, 2)], offset=4)
        g1 = q.get_nbi(h["buf"], [(1, 0), (0, 2)])
        g2 = q.get_nbi(h["buf"], [(2, 1)], offset=2, size=3)
        r1 = q.allreduce_nbi(side.arr(np.arange(3.0)), lambda x: x * 2)
        r2 = q.allreduce_nbi(side.arr(np.ones(2)), lambda x: x + 1)
        with pytest.raises(RuntimeError):
            g1.value()
        q.quiet()
        out[port] = ([np.asarray(g.value()) for g in (g1, g2)]
                     + [np.asarray(r.value()) for r in (r1, r2)],
                     side.state()["buf"], q.stats(), q.phase_stats("stream"))
    (vj, bj, sj, pj), (vt, bt, st, pt) = out[False], out[True]
    for a, b in zip(vt, vj):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(bt, bj)
    assert st == sj and pt == pj
    assert st["coalesced"] >= 1


def test_signal_wait_and_amo_validation_match_reference():
    """The error contract: a wait that nothing pending can satisfy
    raises; bad AMO arguments raise ValueError — on both sides."""
    for port in (False, True):
        side = _Side(port, seed=None)
        q, h = side.q, side.h
        with pytest.raises(RuntimeError, match="block forever"):
            q.signal_wait_until(h["sig"], "eq", 5, sig_offset=1, pe=0)
        with pytest.raises(ValueError, match="unknown signal comparison"):
            q.signal_wait_until(h["sig"], "??", 0, sig_offset=0, pe=0)
        with pytest.raises(ValueError):
            q.amo_nbi(h["ctr"], "fadd", [(0, 1), (1, 2)], value=1)
        with pytest.raises(ValueError):
            q.amo_nbi(h["ctr"], "cswap", [(0, 1)], value=1)
        with pytest.raises(ValueError):
            q.put_signal_nbi(h["buf"], side.arr(np.zeros((N_PE, 1),
                                                         np.float32)),
                             [(0, 1)], h["sig"], 1, sig_op="bogus")
        q.put_signal_nbi(h["buf"], side.arr(np.ones((N_PE, 1), np.float32)),
                         [(0, 1)], h["sig"], 4, sig_offset=2, sig_op="add")
        q.signal_wait_until(h["sig"], "ge", 4, sig_offset=2, pe=1)
        q.signal_reset(h["sig"], [(0, 1)], sig_offset=2)
        assert int(side.state()["sig"][1, 2]) == 0
        assert q.stats()["signal_resets"] == 1


@pytest.mark.parametrize("chunk", range(2))
def test_permute_transport_equals_local_transport(chunk):
    """The port's stacked PermuteTransport (p2p.heap_put/heap_get rounds)
    delivers what its LocalTransport does, for put and put-with-signal
    sequences under every seed, and get_nbi reads the same rows."""
    for i in range(10):
        events = gen_signal_sequence(random.Random(13000 + chunk * 10 + i))
        for seed in SEEDS:
            want = _replay(_Side(True, seed, "local"), events)
            got = _replay(_Side(True, seed, "permute"), events)
            _assert_same(got, want, f"seq {i} seed {seed}")
    for tr in ("local", "permute"):
        side = _Side(True, None, tr)
        side.q.put_nbi(T["buf"], torch.arange(N_PE * 2.0).reshape(N_PE, 2),
                       [(0, 1), (1, 2), (2, 0)], offset=3)
        g = side.q.get_nbi(T["buf"], [(1, 2), (0, 1)], offset=2, size=3)
        side.q.quiet()
        if tr == "local":
            ref = g.value()
        else:
            assert torch.equal(g.value(), ref)


def test_permute_transport_rounds_are_staged():
    """Under a stager every delivered payload of the PermuteTransport
    passes through it (the pallas backend's copy-engine seam)."""
    from repro_torch.core import p2p
    seen = []

    def stager(x):
        seen.append(tuple(x.shape))
        return x.clone()

    side = _Side(True, None, "permute")
    with p2p.staged_payloads(stager):
        side.q.put_nbi(T["buf"], torch.ones(N_PE, 2), [(0, 1)], offset=0)
        side.q.put_nbi(T["buf"], torch.ones(N_PE, 1), [(1, 0)], offset=4)
        side.q.quiet()
    assert seen == [(N_PE, 2), (N_PE, 1)]
    assert side.state()["buf"][1, :2].tolist() == [1.0, 1.0]
