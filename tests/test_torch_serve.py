"""repro_torch serving host side and end to end, against the JAX
reference on the same inputs: heap offsets, ``PagedKVCache`` grants,
``truncate`` and block tables, FCFS scheduler plans, traffic traces,
and the token streams of the whole engine (the port on the CPU, the
reference with ``attn_impl="ref"``) for the same ``from_jax`` weights
and requests — greedy and sampled, across prefill chunkings.  Plus the
device contract (no GPU -> raise), the explicit refusals of what later
slices bring, and the prefix cache: registration, the pin budget,
``put_nbi`` page migration drained by one ``quiet()``, and a prefix-hit
resume whose stream equals the first serve's and the reference's.

Host bookkeeping and token streams must be EQUAL; nothing here has a
tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import serve as jserve
from repro.core.heap import SymmetricHeap as JHeap
from repro.models import registry
from repro.parallel.ctx import ParallelCtx
from repro_torch import configs, serve
from repro_torch.core.heap import SymmetricHeap
from repro_torch.launch import serve as launch
from repro_torch.weights import from_jax

torch.set_num_threads(2)

PROMPTS = [list(range(3, 9)), list(range(4, 10)), [7, 3, 99, 12]]


# ======================================================================
# heap, KV cache, scheduler, traffic: same inputs, same decisions
# ======================================================================
def _blocks(heap):
    return [(b.offset, b.nbytes, b.free, b.name) for b in heap._blocks]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_heap_offsets_match_reference(seed):
    rng = np.random.RandomState(seed)
    ours, ref = SymmetricHeap(("data",), 1 << 22), JHeap(("data",), 1 << 22)
    live = []
    for step in range(60):
        op = rng.randint(3) if live else 0
        if op == 0:
            name = f"o{step}"
            shape = (int(rng.randint(1, 300)), int(rng.randint(1, 5)))
            dtype = [np.float32, np.int8, np.float64][rng.randint(3)]
            align = [None, 64, 4096][rng.randint(3)]
            a = ours.alloc(name, shape, dtype, align=align)
            b = ref.alloc(name, shape, dtype, align=align)
            assert (a.offset, a.nbytes) == (b.offset, b.nbytes)
            live.append(name)
        elif op == 1:
            name = live.pop(rng.randint(len(live)))
            ours.free(name)
            ref.free(name)
        else:
            name = live[rng.randint(len(live))]
            shape = (int(rng.randint(0, 600)),)
            a = ours.realloc(name, shape, np.float32)
            b = ref.realloc(name, shape, np.float32)
            if b is None:
                assert a is None
                live.remove(name)
            else:
                assert (a.offset, a.nbytes) == (b.offset, b.nbytes)
        assert _blocks(ours) == _blocks(ref)
    for name in live:
        assert ours.resolve(ours.addr_of(name)) == (ours.registry[name], 0)


def _kv_pair(n_pages=12, page_tokens=4):
    geo = dict(n_layers=2, kv_heads=2, head_dim=4, n_pages=n_pages,
               page_tokens=page_tokens)
    return (serve.PagedKVCache(SymmetricHeap(("data",), 1 << 24), **geo),
            jserve.PagedKVCache(JHeap(("data",), 1 << 24), **geo))


def test_kv_cache_grants_truncate_and_block_tables_match():
    ours, ref = _kv_pair()
    assert ours.handle.shape == ref.handle.shape == (12, 2, 2, 4, 2, 4)
    assert ours.handle.offset == ref.handle.offset
    script = [("alloc", "a", 6), ("alloc", "b", 9), ("ensure", "a", 11),
              ("truncate", "b", 5), ("alloc", "c", 3), ("free", "a", 0),
              ("alloc", "d", 13), ("ensure", "c", 16), ("truncate", "d", 0),
              ("ensure", "d", 7), ("alloc", "e", 40), ("free", "c", 0)]
    for op, sid, n in script:
        if op == "alloc":
            assert ours.alloc_seq(sid, n) == ref.alloc_seq(sid, n)
        elif op == "ensure":
            assert ours.ensure(sid, n) == ref.ensure(sid, n)
        elif op == "truncate":
            assert ours.truncate(sid, n) == ref.truncate(sid, n)
        else:
            ours.free_seq(sid)
            ref.free_seq(sid)
        assert ours.tables == ref.tables, (op, sid)
        assert ours._free == ref._free, (op, sid)
        sids = sorted(ours.tables) + [None]
        np.testing.assert_array_equal(ours.block_table(sids, 6),
                                      ref.block_table(sids, 6))
    assert 0 not in ours._free                     # null page never granted
    assert ours.stats["rewound_pages"] == ref.stats["rewound_pages"]


@pytest.mark.parametrize("n_pages,chunk,tick_tokens",
                         [(40, 4, 0), (9, 3, 5), (7, 2, 0)])
def test_scheduler_plans_match_reference(n_pages, chunk, tick_tokens):
    """Drive both schedulers through the same trace (prefill chunks,
    decode tokens, finishes, and — with a tight pool — preemptions):
    every tick's plan and every request's progress must be equal."""
    ours_kv, ref_kv = _kv_pair(n_pages=n_pages, page_tokens=4)
    kw = dict(max_batch=3, max_seq=48, prefill_chunk=chunk,
              tick_tokens=tick_tokens)
    ours = serve.FCFSScheduler(ours_kv, **kw)
    ref = jserve.FCFSScheduler(ref_kv, **kw)
    rng = np.random.RandomState(n_pages)
    specs = [(list(rng.randint(0, 100, rng.randint(2, 14))),
              int(rng.randint(2, 9))) for _ in range(7)]
    reqs = ([serve.Request(rid=i, prompt=p, max_new=m)
             for i, (p, m) in enumerate(specs)],
            [jserve.Request(rid=i, prompt=p, max_new=m)
             for i, (p, m) in enumerate(specs)])
    for a, b in zip(*reqs):
        ours.submit(a)
        ref.submit(b)
    preempted = 0
    for tick in range(200):
        if not ref.has_work():
            break
        pa_, pb = ours.tick(tick), ref.tick(tick)
        assert [r.rid for r in pa_.admitted] == [r.rid for r in pb.admitted]
        assert [r.rid for r in pa_.preempted] == [r.rid for r in pb.preempted]
        assert [(r.rid, n) for r, n in pa_.prefill] == \
            [(r.rid, n) for r, n in pb.prefill]
        preempted += len(pb.preempted)
        for sched, plan, is_ref in ((ours, pa_, False), (ref, pb, True)):
            chunked = {r.rid for r, _ in plan.prefill}
            for r, n in plan.prefill:
                sched.note_chunk(r, n, 42 + r.rid, tick)
            for r in list(sched.running):
                if r.rid not in chunked and not r.is_prefilling():
                    sched.advance(r, 7, tick)
                if not r.is_prefilling() and r.finished():
                    sched.finish(r, tick, register_prefix=False)
        assert ours_kv.tables == ref_kv.tables
        assert [(r.rid, r.n_done, r.out) for r in ours.running] == \
            [(r.rid, r.n_done, r.out) for r in ref.running]
    assert not ours.has_work() and not ref.has_work()
    assert ours.stats["preempted"] == ref.stats["preempted"] == preempted
    if n_pages == 7:
        assert preempted > 0, "the tight pool must exercise eviction"


@pytest.mark.parametrize("kw", [
    {},
    dict(n_requests=20, rate=3.0, seed=5, temperature=0.8, top_k=4,
         top_p=0.9, greedy_frac=0.5),
    dict(n_requests=12, seed=9, interactive_frac=0.5, batch_frac=0.25,
         deadline_interactive=0.5, deadline_batch=2.0, n_tenants=3,
         prompt_short=(64, 257), prompt_long=(257, 513),
         out_short=(32, 65), out_long=(32, 65), vocab=151936),
])
def test_traffic_traces_identical_to_reference(kw):
    fields = ("rid", "prompt", "max_new", "t_arrive", "priority",
              "deadline", "tenant")
    ours = serve.make_requests(serve.TrafficConfig(**kw))
    ref = jserve.make_requests(jserve.TrafficConfig(**kw))
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert [getattr(a, f) for f in fields] == \
            [getattr(b, f) for f in fields]
        assert dataclasses.asdict(a.sampling) == dataclasses.asdict(b.sampling)


# ======================================================================
# end to end: the port's engine on the CPU vs the JAX engine
# ======================================================================
@pytest.fixture(scope="module")
def weights():
    jcfg = jconfigs.get_smoke("qwen3-8b")
    ctx = ParallelCtx(dp_size=1, tp_size=1, sp=False, remat=False,
                      param_dtype=jnp.float32, compute_dtype=jnp.float32)
    jparams = registry.build(jcfg).init(jax.random.PRNGKey(0), jcfg, ctx)
    return (jcfg, ctx, jparams, configs.get_smoke("qwen3-8b"),
            from_jax(jax.tree.map(np.asarray, jparams)))


def _reqs(mod, specs):
    return [mod.Request(rid=i, prompt=list(p), max_new=m, **kw)
            for i, (p, m, kw) in enumerate(specs)]


def _jax_streams(weights, specs, **scfg_kw):
    jcfg, ctx, jparams, _, _ = weights
    kw = dict(page_tokens=4, n_pages=32, max_batch=3, max_seq=32,
              attn_impl="ref")
    kw.update(scfg_kw)
    eng = jserve.ServeEngine(jparams, jcfg, ctx, jserve.ServeConfig(**kw))
    done = eng.run(_reqs(jserve, specs), clock="tick")
    return {r.rid: list(r.out) for r in done}


def _port_run(weights, specs, **scfg_kw):
    cfg, params = weights[3], weights[4]
    kw = dict(page_tokens=4, n_pages=32, max_batch=3, max_seq=32,
              attn_impl="kernel")
    kw.update(scfg_kw)
    eng = serve.ServeEngine(params, cfg, serve.ServeConfig(**kw),
                            device="cpu")
    done = eng.run(_reqs(serve, specs), clock="tick")
    return ({r.rid: list(r.out) for r in done},
            {r.rid: list(r.prefill_chunks) for r in done}, eng)


GREEDY_SPECS = [(p, 5, {}) for p in PROMPTS]


@pytest.fixture(scope="module")
def jax_greedy(weights):
    """The reference's streams: the whole prompt in one chunk."""
    return _jax_streams(weights, GREEDY_SPECS, prefill_chunk=16)


@pytest.mark.parametrize("attn_impl", ["kernel", "ref"])
def test_engine_greedy_streams_equal_jax_engine(weights, jax_greedy,
                                                attn_impl):
    streams, _, eng = _port_run(weights, GREEDY_SPECS, prefill_chunk=16,
                                attn_impl=attn_impl)
    assert streams == jax_greedy
    assert eng.steps["prefill"] > 0 and eng.steps["decode"] > 0


@pytest.mark.parametrize("chunk,tick_tokens",
                         [(1, 0), (2, 0), (3, 0), (3, 4), (5, 7)])
def test_engine_streams_invariant_to_prefill_chunking(weights, jax_greedy,
                                                      chunk, tick_tokens):
    """Any (prefill_chunk, tick_tokens) gives the reference's monolithic
    streams — chunks that end mid-page (prompt 6 over 4-token pages,
    chunk 3) and the first decode right after one included."""
    streams, chunks, _ = _port_run(weights, GREEDY_SPECS,
                                   prefill_chunk=chunk,
                                   tick_tokens=tick_tokens)
    assert streams == jax_greedy
    assert all(max(c) <= chunk for c in chunks.values())
    if (chunk, tick_tokens) == (3, 0):
        assert chunks[0] == [3, 3]


def test_engine_sampled_streams_equal_jax_engine(weights):
    """Greedy and sampled requests in one batch: the threefry draws keyed
    (seed, rid, position) give the reference's streams."""
    sp = dict(temperature=0.9, top_k=5, top_p=0.9)
    specs = [([5, 17, 42] * 4, 8, {}),
             ([5, 17, 42] * 3, 8, {"sampling": sp}),
             ([7, 3, 99, 12], 8, {"sampling": dict(temperature=1.3)})]
    jspecs = [(p, m, {"sampling": jserve.SamplingParams(**kw["sampling"])}
               if kw else {}) for p, m, kw in specs]
    tspecs = [(p, m, {"sampling": serve.SamplingParams(**kw["sampling"])}
               if kw else {}) for p, m, kw in specs]
    want = _jax_streams(weights, jspecs, n_pages=48, max_seq=48,
                        sample_seed=11)
    got, _, _ = _port_run(weights, tspecs, n_pages=48, max_seq=48,
                          sample_seed=11)
    assert got == want


def test_engine_preempted_request_eventually_completes(weights):
    specs = [(list(range(2 + i, 10 + i)), 8, {}) for i in range(3)]
    tight, _, eng = _port_run(weights, specs, n_pages=8)
    assert eng.sched.stats["preempted"] > 0
    roomy, _, _ = _port_run(weights, specs, n_pages=32)
    assert tight == roomy


def test_engine_metrics_and_page_writes(weights):
    """Every request's pages hold its K/V: after a run, re-attending the
    last written position through the engine's own pool reproduces the
    decode step (pages written in place, page 0 excluded)."""
    _, _, eng = _port_run(weights, GREEDY_SPECS, prefill_chunk=4)
    m = eng.metrics()
    assert m["requests"] == 3 and m["tokens_out"] == 15
    assert m["steps"]["prefill"] + m["steps"]["decode"] <= m["ticks"] * 2
    assert eng.kv.n_free() == eng.kv.n_pages - 1     # all pages returned
    assert float(eng.pool[1:].abs().sum()) > 0       # pages were written


# ======================================================================
# device contract and the slices still to come
# ======================================================================
def test_build_engine_without_device_raises_when_cuda_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.build_engine(config="smoke")
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.build_engine(config="smoke", device="cuda")
    eng, cfg = launch.build_engine(config="smoke", dtype="f32", device="cpu",
                                   page_tokens=4, n_pages=16, max_batch=2,
                                   prefill_chunk=4)
    assert eng.device.type == "cpu" and cfg.n_layers == 2


@pytest.mark.parametrize("what", ["ssm", "swa", "disagg", "router_amo",
                                  "cli_hot_swap"])
def test_later_slices_raise_not_implemented(what):
    small = dict(config="smoke", dtype="f32", device="cpu", page_tokens=4,
                 n_pages=16, max_batch=2, prefill_chunk=4)
    cli = ["--config", "smoke", "--device", "cpu", "--dtype", "f32"]
    with pytest.raises(NotImplementedError):
        if what == "disagg":
            launch.build_engine(disagg="1+1", **small)
        elif what == "router_amo":
            launch.build_engine(router="amo", **small)
        elif what == "cli_hot_swap":
            launch.main(cli + ["--hot-swap"])
        else:
            # an SSM family, or the sliding window over the paged cache
            kw = (dict(family="ssm", ssm_state=16) if what == "ssm"
                  else dict(swa_window=8))
            cfg = dataclasses.replace(configs.get_smoke("qwen3-8b"), **kw)
            serve.ServeEngine({}, cfg, serve.ServeConfig(), device="cpu")


@pytest.mark.parametrize("kw", [dict(spec_k=2), dict(spec_k=2, draft="qwen3-8b"),
                                dict(prefix_keep=True),
                                dict(slo=serve.SLOConfig())],
                         ids=["spec", "draft", "prefix", "slo"])
def test_new_paths_run_on_the_card_unless_asked(monkeypatch, kw):
    """``build_engine`` with speculation, a draft model, prefix keeping or
    the SLO policy raises without a GPU unless ``device="cpu"`` is
    passed; on the CPU it builds and serves."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = dict(config="smoke", dtype="f32", page_tokens=4, n_pages=16,
                 max_batch=2, prefill_chunk=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.build_engine(**small, **kw)
    eng, cfg = launch.build_engine(device="cpu", **small, **kw)
    assert eng.device.type == "cpu"
    if "draft" in kw:
        assert eng.proposer.device.type == "cpu"
        assert eng.proposer.kv is eng.kv
    done = eng.run([serve.Request(rid=0, prompt=[5, 17, 42] * 2, max_new=4)],
                   clock="tick")
    assert len(done[0].out) == 4


def test_cli_serves_smoke_config_on_cpu(capsys):
    launch.main(["--config", "smoke", "--device", "cpu", "--dtype", "f32",
                 "--requests", "3", "--page-tokens", "4", "--n-pages", "32",
                 "--max-batch", "2", "--prefill-chunk", "4", "--trace"])
    out = capsys.readouterr().out
    assert "arch=qwen3-8b-smoke device=cpu" in out
    assert '"requests": 3' in out


# ======================================================================
# prefix cache and page migration: put_nbi per page, ONE quiet()
# ======================================================================
def test_page_migration_put_nbi_one_quiet():
    """N migrations issue N put_nbi and drain with ONE quiet(); the
    destination PE's rows equal the source's pages, as the reference's
    (LocalTransport, two PEs, adjacent pages coalesced)."""
    from repro.core import CommQueue as JQueue, LocalTransport as JLocal
    from repro_torch.core import CommQueue, LocalTransport

    ours, ref = _kv_pair(n_pages=8)
    rng = np.random.RandomState(0)
    system = rng.randn(2, *ours.handle.shape).astype(np.float32)
    out = {}
    for kv, queue, tr, mod, arr in (
            (ours, CommQueue, LocalTransport, serve, torch.from_numpy),
            (ref, JQueue, JLocal, jserve, np.array)):
        migs = [mod.PageMigration(src_pe=0, dst_pe=1, src_page=3,
                                  dst_page=5),
                mod.PageMigration(src_pe=0, dst_pe=1, src_page=4,
                                  dst_page=6)]
        state = {kv.handle.name: arr(system.copy())}
        q = queue("pe", state, transport=tr(2))
        if mod is serve:
            got = kv.issue_migrations(q, state[kv.handle.name], migs)
        else:
            got = kv.issue_migrations(q, state[kv.handle.name], migs,
                                      system=True)
        st = q.stats()
        out[mod] = (np.asarray(got[kv.handle.name]),
                    {k: st[k] for k in ("puts", "quiets", "coalesced")},
                    kv.stats["migrations"])
    assert out[serve][1] == out[jserve][1] == \
        {"puts": 2, "quiets": 1, "coalesced": 1}
    assert out[serve][2] == out[jserve][2] == 2
    np.testing.assert_array_equal(out[serve][0], out[jserve][0])
    np.testing.assert_array_equal(out[serve][0][1, 5], system[0, 3])
    untouched = np.ones(8, bool)
    untouched[[5, 6]] = False
    np.testing.assert_array_equal(out[serve][0][1][untouched],
                                  system[1][untouched])


def test_engine_migration_lands_in_the_pool_in_place(count_quiets):
    """``LocalExec.migrate``: one put_nbi per page and one quiet, the
    pages written into the engine's own pool tensor (no copy of it)."""
    eng = serve.ServeEngine({}, configs.get_smoke("qwen3-8b"),
                            serve.ServeConfig(page_tokens=4, n_pages=12),
                            device="cpu")
    pool = eng.pool
    pool.copy_(torch.randn(pool.shape, generator=torch.Generator()
                           .manual_seed(0)))
    before = pool.clone()
    migs = tuple(serve.PageMigration(0, 0, s, d)
                 for s, d in ((2, 9), (3, 10), (7, 4)))
    got = eng.exec.migrate(pool, migs)
    assert got is pool
    assert [(q["puts"], q["quiets"], q["coalesced"])
            for q in count_quiets] == [(3, 1, 1)]
    for m in migs:
        torch.testing.assert_close(pool[m.dst_page], before[m.src_page],
                                   rtol=0, atol=0)
    keep = [i for i in range(12) if i not in (9, 10, 4)]
    torch.testing.assert_close(pool[keep], before[keep], rtol=0, atol=0)


def test_prefix_pin_budget_bounds_the_cache():
    ours, ref = _kv_pair(n_pages=9)
    for kv in (ours, ref):
        assert kv.pin_budget == 2
        assert kv.alloc_seq("a", 8)
        assert kv.register_prefix(list(range(8)), 0, kv.tables["a"][:2])
        assert kv.pinned_pages == 2
        assert kv.alloc_seq("b", 8)
        assert not kv.register_prefix(list(range(20, 28)), 0,
                                      kv.tables["b"][:2])   # over budget
        assert kv.pinned_pages == 2
    assert ours._prefix == ref._prefix and ours.tables == ref.tables
    assert serve.PagedKVCache(SymmetricHeap(("data",), 1 << 24),
                              n_layers=1, kv_heads=1, head_dim=4,
                              n_pages=64, page_tokens=4).pin_budget == 15


def test_prefix_cache_registration_and_lookup():
    ours, ref = _kv_pair(n_pages=10)
    prompt = list(range(11))                   # 2 full pages + 3 tokens
    for kv in (ours, ref):
        assert kv.alloc_seq("a", len(prompt) + 1)
        pages = kv.tables["a"]
        assert kv.register_prefix(prompt, owner_pe=0, pages=pages[:2])
        assert not kv.register_prefix(prompt, owner_pe=1, pages=pages[:2])
        assert kv.lookup_prefix(prompt + [99, 98]) == (0, pages[:2])
        # only whole registered keys hit: one matching page is no hit
        assert kv.lookup_prefix(prompt[:5] + [1, 2, 3]) is None
        assert kv.lookup_prefix([5, 5, 5, 5]) is None
        taken = kv.take_pages(3)
        kv.attach_seq("b", taken)
        assert kv.tables["b"] == taken
        with pytest.raises(ValueError):
            kv.attach_seq("b", taken)
        assert kv.take_pages(100) is None
    assert ours.tables == ref.tables and ours._free == ref._free
    assert ours.stats["page_allocs"] == ref.stats["page_allocs"]


def _count_quiets(monkeypatch, engine_module) -> list:
    """Record the stats of every CommQueue ``engine_module`` drains."""
    seen = []

    class Counted(engine_module.CommQueue):
        def quiet(self):
            out = super().quiet()
            seen.append(self.stats())
            return out

    monkeypatch.setattr(engine_module, "CommQueue", Counted)
    return seen


@pytest.fixture
def count_jax_quiets(monkeypatch):
    from repro.serve import engine as jengine
    return _count_quiets(monkeypatch, jengine)


@pytest.fixture
def count_quiets(monkeypatch):
    from repro_torch.serve import engine
    return _count_quiets(monkeypatch, engine)


@pytest.mark.parametrize("spec_k", [0, 2])
def test_local_prefix_hit_resumes_via_self_pair_copy(weights,
                                                     count_jax_quiets,
                                                     count_quiets, spec_k):
    """A same-PE prefix hit reuses the pinned pages through put_nbi with
    self-pairs (one put per page, one quiet on that tick): the re-served
    prompt gives the first serve's stream, the reference's stream, and
    the uncovered suffix prefills in one >= 2-token chunk."""
    jcfg, ctx, jparams, cfg, params = weights
    kw = dict(page_tokens=4, n_pages=32, max_batch=2, max_seq=32,
              prefill_chunk=4, prefix_keep=True, spec_k=spec_k)
    jeng = jserve.ServeEngine(jparams, jcfg, ctx,
                              jserve.ServeConfig(attn_impl="ref", **kw))
    eng = serve.ServeEngine(params, cfg, serve.ServeConfig(**kw),
                            device="cpu")
    prompt = list(range(5, 16))                # 2 full pages + 3 extra
    res = {}
    for mod, e in ((jserve, jeng), (serve, eng)):
        first = e.run([mod.Request(rid=0, prompt=list(prompt), max_new=5)],
                      clock="tick")[0]
        assert e.kv.pinned_pages == 2
        e.submit(mod.Request(rid=1, prompt=list(prompt), max_new=5))
        while e.sched.has_work():
            e.tick()
        again = next(r for r in e.finished if r.rid == 1)
        assert again.out == first.out
        assert e.kv.lookup_prefix(prompt) is not None   # originals intact
        res[mod] = (first.out, again.prefill_chunks, e.sched.stats["resumed"],
                    e.kv.stats["migrations"], e.kv.stats["prefix_hits"])
    assert res[serve] == res[jserve]
    assert res[serve][1:] == ([3], 1, 2, 1)
    assert [(q["puts"], q["quiets"]) for q in count_quiets] == [(2, 1)]
    assert [(q["puts"], q["quiets"]) for q in count_jax_quiets] == [(2, 1)]
    assert eng.metrics()["kv"] == {k: jeng.metrics()["kv"][k]
                                   for k in eng.kv.stats}
