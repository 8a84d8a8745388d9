"""repro_torch.serve.disagg: disaggregated prefill/decode cells with
put-with-signal page handoff, the AMO router and the page pool behind
it, against the JAX package — case for case with ``tests/test_disagg.py``
(the 8-PE mesh suite aside).

  * the cross-cache paths on ``PagedKVCache`` (export, adopt, release,
    truncate and growth of an adopted table, prefix pins), each grant
    equal to the JAX cache's;
  * ``make_cells``, the host router's least-loaded admission and its
    handoff backpressure;
  * end to end on the smoke qwen3-8b, the same ``from_jax`` weights and
    trace (greedy and sampled): for 1+1 and 2+2, ``spec_k`` 0 and 2,
    router ``host`` and ``amo``, the port's streams equal the JAX
    ``DisaggEngine``'s and the port's own colocated engine's, and
    ``stats()``, every cell's scheduler and cache counters, and each
    ticket's source and landing pages equal the reference's; the handoff
    drains by ``signal_wait_until`` alone (zero quiets) and the landed
    rows are the producer's rows;
  * conservation after the ack, colocated ``amo`` == colocated ``host``,
    the CLI builder, and the mailbox's placement (KV rows on the
    engine's device, every control word a CPU int64).

The JAX runs are cached per module; JAX cells share one jitted
``LocalExec`` per ``spec_k`` (its step functions take the pool as an
argument), so the reference compiles once.  Nothing here has a
tolerance.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import serve as jserve
from repro.core.heap import SymmetricHeap as JHeap
from repro.launch import serve as jlaunch
from repro.models import registry
from repro.parallel.ctx import ParallelCtx
from repro_torch import configs, serve
from repro_torch.core.heap import SymmetricHeap
from repro_torch.launch import serve as launch
from repro_torch.weights import from_jax

torch.set_num_threads(2)


def _kv_pair(n_pages=8, page_tokens=4):
    geo = dict(n_layers=2, kv_heads=2, head_dim=4, n_pages=n_pages,
               page_tokens=page_tokens)
    return (serve.PagedKVCache(SymmetricHeap(("data",), 1 << 24), **geo),
            jserve.PagedKVCache(JHeap(("data",), 1 << 24), **geo))


def _both(pair, fn):
    """Run ``fn`` on the port's cache and the JAX one; equal results."""
    a, b = fn(pair[0]), fn(pair[1])
    assert a == b, (a, b)
    return a


# ======================================================================
# PagedKVCache: the cross-cache handoff paths
# ======================================================================
def test_export_seq_detaches_without_freeing():
    kv = _kv_pair()
    assert _both(kv, lambda k: k.alloc_seq("s", 7))       # 2 pages
    pages = list(kv[0].tables["s"])
    free_before = kv[0].n_free()
    exported = _both(kv, lambda k: k.export_seq("s"))
    assert exported == pages and "s" not in kv[0].tables
    # resident as the payload source until the consumer acknowledges
    assert kv[0].n_free() == free_before
    assert not set(exported) & set(kv[0]._free)
    assert kv[0].stats["exported_pages"] == 2
    _both(kv, lambda k: k.release_pages(exported))
    assert kv[0].n_free() == free_before + 2
    assert kv[0]._free == kv[1]._free
    assert kv[0].stats == kv[1].stats


def test_adopt_seq_remaps_block_table_on_consumer():
    """The landing ids are the consumer's own: a handoff remaps the block
    table, it never forwards producer page ids."""
    prod, cons = _kv_pair(), _kv_pair()
    assert _both(cons, lambda k: k.alloc_seq("skew", 9))  # eats 7, 6, 5
    assert _both(prod, lambda k: k.alloc_seq("s", 7))
    src = _both(prod, lambda k: k.export_seq("s"))
    dst = _both(cons, lambda k: k.adopt_seq("s", len(src)))
    assert dst is not None and len(dst) == len(src)
    assert set(dst).isdisjoint(src)
    bt = cons[0].block_table(["s"], 4)
    np.testing.assert_array_equal(bt, cons[1].block_table(["s"], 4))
    assert list(bt[0, :2]) == dst and bt[0, 2] == 0
    assert cons[0].stats["adopted_pages"] == 2
    assert _both(cons, lambda k: k.adopt_seq("t", 99)) is None
    assert "t" not in cons[0].tables
    assert cons[0].stats == cons[1].stats


def test_adopted_sequence_truncates_and_grows_like_native():
    prod, cons = _kv_pair(), _kv_pair()
    assert _both(prod, lambda k: k.alloc_seq("s", 12))    # 3 pages
    n = len(_both(prod, lambda k: k.export_seq("s")))
    dst = _both(cons, lambda k: k.adopt_seq("s", n))
    assert _both(cons, lambda k: k.ensure("s", 14))       # grow into page 4
    assert len(cons[0].tables["s"]) == 4
    assert _both(cons, lambda k: k.truncate("s", 6)) == 2
    assert cons[0].tables["s"] == dst[:2]
    assert cons[0].stats["rewound_pages"] == 2
    assert set(cons[0]._free) >= {dst[2]}
    assert cons[0]._free == cons[1]._free


def test_exported_pages_stay_out_of_prefix_pin_circulation():
    prod, cons = _kv_pair(n_pages=16), _kv_pair(n_pages=16)
    prompt = list(range(8))                  # 2 full pages
    assert _both(prod, lambda k: k.alloc_seq("s", 9))
    src = _both(prod, lambda k: k.export_seq("s"))
    with pytest.raises(KeyError):
        prod[0].tables["s"]                  # nothing left to pin
    dst = _both(cons, lambda k: k.adopt_seq("s", len(src)))
    assert _both(cons, lambda k: k.register_prefix(prompt, 1, dst[:2]))
    assert cons[0].lookup_prefix(prompt + [77]) == (1, dst[:2])
    assert cons[0].pinned_pages == 2
    _both(prod, lambda k: k.release_pages(src))
    assert prod[0].pinned_pages == 0 and prod[0]._free == prod[1]._free


# ======================================================================
# topology: cells and the host router
# ======================================================================
def test_make_cells_carves_active_sets():
    cells = serve.make_cells(2, 2, pes_per_cell=2)
    assert [c.role for c in cells] == ["prefill"] * 2 + ["decode"] * 2
    assert [c.pes for c in cells] == [(0, 1), (2, 3), (4, 5), (6, 7)]
    assert [(c.cell, c.role, c.pes) for c in cells] == [
        (c.cell, c.role, c.pes) for c in jserve.make_cells(2, 2, 2)]
    with pytest.raises(ValueError):
        serve.make_cells(0, 2)


@pytest.fixture(scope="module")
def weights():
    jcfg = jconfigs.get_smoke("qwen3-8b")
    ctx = ParallelCtx(dp_size=1, tp_size=1, sp=False, remat=False,
                      param_dtype=jnp.float32, compute_dtype=jnp.float32)
    jparams = registry.build(jcfg).init(jax.random.PRNGKey(0), jcfg, ctx)
    return (jcfg, ctx, jparams, configs.get_smoke("qwen3-8b"),
            from_jax(jax.tree.map(np.asarray, jparams)))


def _small(**kw):
    return serve.ServeConfig(page_tokens=4, n_pages=32, max_batch=2,
                             max_seq=32, **kw)


def test_router_least_loaded_admission(weights):
    cfg, params = weights[3], weights[4]
    eng = serve.DisaggEngine(params, cfg, _small(), device="cpu",
                             n_prefill=2, n_decode=1)
    r0 = serve.Request(rid=0, prompt=list(range(3, 11)), max_new=2)
    r1 = serve.Request(rid=1, prompt=[5, 6, 7], max_new=2)
    eng.submit(r0)                           # cell 0 (both empty, tie)
    assert r0 in eng.engines[0].sched.waiting
    eng.submit(r1)                           # cell 1 is now lighter
    assert r1 in eng.engines[1].sched.waiting
    assert eng.router.prefill_load(0) == 8
    assert eng.router.prefill_load(1) == 3


def test_router_handoff_backpressure(weights):
    """route_handoff gates on live + INBOUND sequences per decode cell; a
    full topology defers (the ticket stays with the producer)."""
    cfg, params = weights[3], weights[4]
    eng = serve.DisaggEngine(params, cfg, _small(), device="cpu",
                             n_prefill=1, n_decode=2)
    router = eng.router
    req = serve.Request(rid=9, prompt=[1, 2], max_new=2)
    assert router.route_handoff(req) == 1    # both empty -> lowest
    router.inbound[1] = 1
    assert router.route_handoff(req) == 2
    router.inbound[2] = 2                    # cell 2 full
    assert router.route_handoff(req) == 1
    router.inbound[1] = 2                    # everything full
    assert router.route_handoff(req) is None


# ======================================================================
# end to end: the port's cells against the JAX cells
# ======================================================================
def _mixed_requests(mod):
    sp = mod.SamplingParams(temperature=0.9, top_k=5, top_p=0.9)
    return [mod.Request(rid=0, prompt=[5, 17, 42] * 4, max_new=8),
            mod.Request(rid=1, prompt=[5, 17, 42] * 3, max_new=8,
                        sampling=sp),
            mod.Request(rid=2, prompt=[7, 3, 99, 12], max_new=8, t_arrive=1),
            mod.Request(rid=3, prompt=list(range(30, 39)), max_new=6,
                        sampling=sp, t_arrive=2),
            mod.Request(rid=4, prompt=[11, 12], max_new=1, t_arrive=2)]


def _scfg(mod, spec_k):
    return mod.ServeConfig(page_tokens=4, n_pages=48, max_batch=3,
                           max_seq=48, spec_k=spec_k,
                           attn_impl="ref" if mod is jserve else "kernel")


def _streams(done):
    return {r.rid: list(r.out) for r in done}


def _record_tickets(eng):
    """Wrap ``eng._put_pages`` to record every ticket it streams."""
    seen = []
    put = eng._put_pages

    def recorded(t):
        seen.append((t.ticket, t.req.rid, t.src_cell, t.dst_cell,
                     list(t.src_pages), list(t.dst_pages), t.word))
        return put(t)

    eng._put_pages = recorded
    return seen


def _summary(eng, tickets):
    cells = [(c["cell"], c["role"], c["pes"], c["sched"], c["kv"])
             for c in eng.metrics()["cells"]]
    return {"streams": _streams(eng.finished), "stats": eng.stats(),
            "tickets": tickets, "cells": cells, "ticks": eng.ticks}


@pytest.fixture(scope="module")
def jax_runs(weights):
    """The reference's runs, cached: ``run(topology, spec_k, router,
    delivery_seed)`` -> summary, and ``colocated(spec_k)`` -> streams.
    Every JAX cell of one ``spec_k`` shares one jitted ``LocalExec``."""
    jcfg, ctx, jparams = weights[:3]

    @functools.lru_cache(maxsize=None)
    def jexec(spec_k):
        kv = jserve.ServeEngine(jparams, jcfg, ctx, _scfg(jserve, spec_k)).kv
        return jserve.LocalExec(jparams, jcfg, ctx, _scfg(jserve, spec_k), kv)

    @functools.lru_cache(maxsize=None)
    def run(topology, spec_k, router, delivery_seed=0):
        cells = jserve.make_cells(*topology)
        engines = [jserve.ServeEngine(jparams, jcfg, ctx,
                                      _scfg(jserve, spec_k),
                                      exec_=jexec(spec_k), role=c.role,
                                      my_pe=c.pes[0]) for c in cells]
        eng = jserve.DisaggEngine(jparams, jcfg, ctx, _scfg(jserve, spec_k),
                                  n_prefill=topology[0],
                                  n_decode=topology[1], engines=engines,
                                  router=router, delivery_seed=delivery_seed)
        tickets = _record_tickets(eng)
        eng.run(_mixed_requests(jserve), clock="tick")
        return _summary(eng, tickets)

    @functools.lru_cache(maxsize=None)
    def colocated(spec_k):
        eng = jserve.ServeEngine(jparams, jcfg, ctx, _scfg(jserve, spec_k),
                                 exec_=jexec(spec_k))
        return _streams(eng.run(_mixed_requests(jserve), clock="tick"))

    return run, colocated


def _port_disagg(weights, topology, spec_k, router, delivery_seed=0):
    cfg, params = weights[3], weights[4]
    eng = serve.DisaggEngine(params, cfg, _scfg(serve, spec_k), device="cpu",
                             n_prefill=topology[0], n_decode=topology[1],
                             router=router, delivery_seed=delivery_seed)
    tickets = _record_tickets(eng)
    eng.run(_mixed_requests(serve), clock="tick")
    return eng, _summary(eng, tickets)


@pytest.mark.parametrize("router", ["host", "amo"])
@pytest.mark.parametrize("spec_k", [0, 2])
@pytest.mark.parametrize("topology", [(1, 1), (2, 2)])
def test_disagg_equals_jax_disagg_and_colocated(weights, jax_runs, topology,
                                                spec_k, router):
    """The tentpole bar: a P+D split gives the colocated engine's streams
    (greedy and sampled, speculation off and on, either router) and the
    reference's cells' — and the same handoff counters, page grants,
    tickets and per-cell scheduler and cache stats; the handoff drains
    through ``signal_wait_until`` alone."""
    run, colocated = jax_runs
    want = run(topology, spec_k, router)
    eng, got = _port_disagg(weights, topology, spec_k, router)
    cfg, params = weights[3], weights[4]
    colo = serve.ServeEngine(params, cfg, _scfg(serve, spec_k), device="cpu")
    colo_streams = _streams(colo.run(_mixed_requests(serve), clock="tick"))
    assert colo_streams == colocated(spec_k)
    assert got["streams"] == want["streams"] == colo_streams
    assert got["stats"] == want["stats"]
    assert got["tickets"] == want["tickets"]
    assert got["cells"] == want["cells"]
    assert got["ticks"] == want["ticks"]
    hs = got["stats"]
    assert hs["handoff_quiets"] == 0
    assert hs["handoff_signals"] == hs["handoff_pages"] > 0
    assert hs["handoff_waits"] == hs["handoff_tickets"]
    # rid 4 (max_new=1) finishes AT prefill: no decode cell saw it
    assert hs["handoff_tickets"] == len(colo_streams) - 1
    assert eng.hq.pending_ops() == 0
    if router == "amo":
        assert hs["router_quiets"] == 0
        assert hs["router_amos"] > 0 and hs["handoff_amos"] > 0
        for pool in eng.pools:
            qs = pool.queue_stats()
            assert qs["quiets"] == 0 and qs["fences"] == 0 and qs["amos"] > 0
    else:
        assert hs["router_amos"] == hs["router_quiets"] == 0
        assert hs["steals"] == hs["alloc_cas_retries"] == 0


def test_amo_control_plane_equals_jax_under_another_delivery_seed(weights,
                                                                  jax_runs):
    """Under delivery seed 7 the AMO router's counters, grants and
    tickets are the reference's under the same seed, and the streams do
    not move."""
    run, colocated = jax_runs
    want = run((2, 2), 0, "amo", 7)
    _, got = _port_disagg(weights, (2, 2), 0, "amo", delivery_seed=7)
    assert got == want
    assert got["streams"] == colocated(0)


def test_handoff_lands_the_producers_rows_and_frees_them_after_ack(weights):
    """A ticket's landed rows in the consumer's pool are the producer's
    rows bit for bit (device copies, no recomputation), and after a whole
    trace every cell's pool is whole again: producers freed exported
    pages on ack, consumers freed adopted tables on finish."""
    cfg, params = weights[3], weights[4]
    eng = serve.DisaggEngine(params, cfg, _small(), device="cpu",
                             n_prefill=1, n_decode=1)
    landed = []
    put = eng._put_pages

    def check(t):
        src = eng.engines[t.src_cell]
        landed.append((t, src.pool[t.src_pages].clone()))
        return put(t)

    drain = eng._drain_inbox

    def drained(cell, now):
        n = len(landed)
        drain(cell, now)
        for t, rows in landed[:n]:
            if t.dst_cell == cell:
                dst = eng.engines[cell].pool
                assert torch.equal(dst[t.dst_pages], rows)
        landed[:] = [x for x in landed[:n] if x[0].dst_cell != cell] \
            + landed[n:]

    eng._put_pages, eng._drain_inbox = check, drained
    done = eng.run(_mixed_requests(serve), clock="tick")
    assert len(done) == 5 and not landed
    for e in eng.engines:
        assert e.kv.n_free() == e.kv.n_pages - 1 - e.kv.pinned_pages
        assert not e.kv.tables
    prod = eng.engines[0].kv
    assert prod.stats["exported_pages"] > 0
    assert prod.stats["page_frees"] >= prod.stats["exported_pages"]


def test_mailbox_placement(weights):
    """KV rows live with the pools (the engine's device), one row block
    per decode cell; the signal, claim, pool and router words are CPU
    int64 control state; a put's payload is its source's row alone."""
    cfg, params = weights[3], weights[4]
    eng = serve.DisaggEngine(params, cfg, _small(), device="cpu",
                             n_prefill=2, n_decode=2, router="amo")
    st = eng.hq.state
    mail = st["kv_mail"]
    assert mail.shape == (2,) + tuple(eng.engines[0].pool.shape)
    assert mail.dtype == eng.engines[0].pool.dtype
    assert mail.device == eng.engines[0].pool.device
    for name in (eng.pad.handle.name, eng._claim.handle.name):
        assert st[name].dtype == torch.int64
        assert st[name].device.type == "cpu"
    for words in [eng.router.q.state[eng.router.pad.handle.name]] + [
            p.q.state[p.pad.handle.name] for p in eng.pools]:
        assert words.dtype == torch.int64 and words.device.type == "cpu"
    sizes = []
    put = eng.hq.put_signal_nbi

    def spy(handle, data, *a, **k):
        sizes.append(tuple(data.shape))
        return put(handle, data, *a, **k)

    eng.hq.put_signal_nbi = spy
    eng.run(_mixed_requests(serve), clock="tick")
    assert sizes and set(sizes) == {(1, 1) + tuple(mail.shape[2:])}


def test_colocated_amo_pool_is_invisible(weights, jax_runs):
    """``router="amo"`` without cells attaches a SymmetricPagePool to the
    single engine's cache: the same grants and streams, zero quiets."""
    cfg, params = weights[3], weights[4]
    host = serve.ServeEngine(params, cfg, _scfg(serve, 0), device="cpu")
    ref = _streams(host.run(_mixed_requests(serve), clock="tick"))
    eng = serve.ServeEngine(params, cfg, _scfg(serve, 0), device="cpu")
    eng.kv.attach_pool(serve.SymmetricPagePool(eng.kv.n_pages))
    got = _streams(eng.run(_mixed_requests(serve), clock="tick"))
    assert got == ref == jax_runs[1](0)
    assert eng.kv.stats == host.kv.stats
    qs = eng.kv._pool.queue_stats()
    assert qs["quiets"] == 0 and qs["fences"] == 0 and qs["amos"] > 0


def test_disagg_cli_spec_and_builder(capsys, monkeypatch):
    assert launch.parse_disagg("2+2") == (2, 2)
    assert launch.parse_disagg("1+3") == (1, 3)
    for bad in ("2", "0+2", "2+0", "a+b"):
        with pytest.raises(SystemExit):
            launch.parse_disagg(bad)
    small = dict(config="smoke", dtype="f32", device="cpu", page_tokens=4,
                 n_pages=32, max_batch=2, prefill_chunk=4)
    eng, cfg = launch.build_engine(disagg="1+1", **small)
    assert isinstance(eng, serve.DisaggEngine)
    assert [c.role for c in eng.cells] == ["prefill", "decode"]
    eng, _ = launch.build_engine(disagg="1+1", router="amo", spec_k=2,
                                 **small)
    assert eng.router_mode == "amo"
    assert isinstance(eng.router, serve.AmoCellRouter)
    assert len(eng.pools) == len(eng.engines)
    # under disagg the proposer is the n-gram self-draft, as in the
    # reference: a draft model the user asked for is replaced by it, with
    # a notice, and the streams are the reference's build_engine's
    assert all(isinstance(e.proposer, serve.NgramProposer)
               for e in eng.engines)
    capsys.readouterr()
    jeng, _ = jlaunch.build_engine("qwen3-8b", page_tokens=4, n_pages=32,
                                   max_batch=2, prefill_chunk=4,
                                   disagg="1+1", spec_k=2, draft="qwen3-8b")
    jparams = from_jax(jax.tree.map(np.asarray,
                                    jeng.engines[0].exec.params))
    monkeypatch.setattr(launch.lm, "init", lambda *a, **k: jparams)
    eng, _ = launch.build_engine(disagg="1+1", spec_k=2, draft="qwen3-8b",
                                 **small)
    err = capsys.readouterr().err
    assert "n-gram" in err and "--draft qwen3-8b is not used" in err
    assert all(isinstance(e.proposer, serve.NgramProposer)
               for e in eng.engines)
    got = _streams(eng.run(_mixed_requests(serve), clock="tick"))
    assert got == _streams(jeng.run(_mixed_requests(jserve), clock="tick"))
    monkeypatch.undo()
    eng, _ = launch.build_engine(router="amo", **small)   # colocated
    assert isinstance(eng, serve.ServeEngine)
    assert isinstance(eng.kv._pool, serve.SymmetricPagePool)
    with pytest.raises(SystemExit):
        launch.build_engine(router="bogus", **small)
    launch.main(["--config", "smoke", "--device", "cpu", "--dtype", "f32",
                 "--requests", "3", "--page-tokens", "4", "--n-pages", "32",
                 "--max-batch", "2", "--prefill-chunk", "4",
                 "--disagg", "1+1", "--router", "amo"])
    out = capsys.readouterr().out
    assert "topology=1+1 router=amo" in out
    assert '"handoff_quiets": 0' in out and '"router_quiets": 0' in out
