"""repro_torch's SLO policy against the JAX reference: priority
admission, inverse-priority preemption, deadline shedding before
best-effort degradation, per-tenant token-rate fairness, the SLO traffic
draws, and the engine under SLO traffic (sheds, attainment,
``slo_summary``) — the port on the CPU, the reference with
``attn_impl="ref"``, the same ``from_jax`` weights and requests.

Mirrors the SLO cases of ``tests/test_slo.py`` (its hot-swap and
disaggregation cases belong to modules not ported yet: A8, A9).  Every
plan, counter and stream must EQUAL the reference's; no tolerance.
"""
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
from repro.serve.slo import rank as jrank
from repro_torch import configs, serve
from repro_torch.core.heap import SymmetricHeap
from repro_torch.launch import serve as launch
from repro_torch.serve.slo import rank
from repro_torch.weights import from_jax

torch.set_num_threads(2)


def mk_pair(n_pages=8, page_tokens=4, max_batch=4, max_seq=32,
            slo_kw=None, **kw):
    """(port, reference) x (scheduler, kv, policy) on the same settings."""
    out = []
    for mod, heap in ((serve, SymmetricHeap), (jserve, JHeap)):
        kv = mod.PagedKVCache(heap(("data",), capacity_bytes=1 << 24),
                              n_layers=2, kv_heads=2, head_dim=4,
                              n_pages=n_pages, page_tokens=page_tokens)
        slo = mod.SLOPolicy(mod.SLOConfig(**(slo_kw or {})))
        out.append((mod, mod.FCFSScheduler(kv, max_batch=max_batch,
                                           max_seq=max_seq, slo=slo, **kw),
                    kv, slo))
    return out


def _rids(rs):
    return [r.rid for r in rs]


# ======================================================================
# policy basics
# ======================================================================
def test_priority_rank_and_validation():
    assert rank("interactive") < rank("batch") < rank("best_effort")
    for p in serve.PRIORITIES:
        assert rank(p) == jrank(p)
    with pytest.raises(ValueError):
        rank("urgent")
    with pytest.raises(ValueError):
        serve.SLOConfig().ttft_target("urgent")
    cfg = serve.SLOConfig(ttft_interactive=1.0, ttft_batch=4.0)
    assert [cfg.ttft_target(p) for p in serve.PRIORITIES] == [1.0, 4.0, None]


def test_priority_admission_jumps_the_backlog():
    seen = []
    for mod, s, _, _ in mk_pair(n_pages=32, max_batch=2):
        for r in [mod.Request(rid=i, prompt=[1, 2, 3], max_new=4,
                              priority="best_effort") for i in (0, 1)] \
                + [mod.Request(rid=2, prompt=[4, 5, 6], max_new=4)]:
            s.submit(r)
        plan = s.tick()
        seen.append((_rids(plan.admitted), s.waiting[0].rid))
    assert seen[0] == seen[1] == ([2, 0], 1)


def test_preemption_is_inverse_priority_not_youngest():
    seen = []
    for mod, s, _, _ in mk_pair(n_pages=6, page_tokens=2, max_batch=3,
                                max_seq=16):
        be = mod.Request(rid=0, prompt=[1, 2, 3], max_new=6,
                         priority="best_effort")
        hi = mod.Request(rid=1, prompt=[4, 5, 6], max_new=6)
        s.submit(be)
        s.tick()
        s.submit(hi)
        s.tick()
        for r in (be, hi):
            s.note_prefilled(r, 9)
            s.advance(r, 9)
        plan = s.tick()
        seen.append((_rids(plan.preempted), _rids(s.running),
                     be.preemptions, be.out))
    assert seen[0] == seen[1] == ([0], [1], 1, [])


def test_deadline_shed_only_best_effort_and_before_admission():
    seen = []
    for mod, s, kv, slo in mk_pair(n_pages=32, max_batch=4):
        be = mod.Request(rid=0, prompt=[1, 2], max_new=2,
                         priority="best_effort", deadline=1.0, t_arrive=0.0)
        hi = mod.Request(rid=1, prompt=[3, 4], max_new=2, deadline=1.0,
                         t_arrive=0.0)
        s.submit(be)
        s.submit(hi)
        plan = s.tick(now=5.0)
        assert plan.shed == [be] and be.shed and be.t_finish == 5.0
        seen.append((s.stats["shed"], slo.stats["shed"],
                     _rids(plan.admitted), 0 in kv.tables))
    assert seen[0] == seen[1] == (1, 1, [1], False)


def test_best_effort_degrades_under_pressure():
    seen = []
    for mod, s, _, slo in mk_pair(n_pages=4, page_tokens=4, max_batch=2,
                                  max_seq=16, prefill_chunk=4):
        be = mod.Request(rid=0, prompt=list(range(10)), max_new=2,
                         priority="best_effort")
        s.submit(be)
        p1 = s.tick()
        alone = ([(r.rid, n) for r, n in p1.prefill], slo.pressure)
        s.note_chunk(be, 4, 9)
        s.submit(mod.Request(rid=1, prompt=[1, 2, 3], max_new=2))
        p2 = s.tick()
        seen.append((alone, slo.pressure, _rids(p2.admitted),
                     [(r.rid, n) for r, n in p2.prefill],
                     slo.stats["degraded_chunks"]))
    assert seen[0] == seen[1] == (([(0, 4)], False), True, [], [(0, 2)], 1)


def test_pressure_strips_best_effort_drafts():
    seen = []
    for mod, s, kv, slo in mk_pair(n_pages=32, max_batch=4, spec_k=2):
        be = mod.Request(rid=0, prompt=[1, 2], max_new=6,
                         priority="best_effort")
        s.submit(be)
        s.tick()
        s.note_prefilled(be, 9)
        full = s.draft_allowance(be)
        s.submit(mod.Request(rid=1, prompt=list(range(20)), max_new=8))
        slo.update_pressure(s.waiting, s.running, kv)
        stripped = s.draft_allowance(be)
        hi = mod.Request(rid=2, prompt=[5, 6], max_new=6)
        s.submit(hi)
        s.tick()
        s.note_prefilled(hi, 9)
        seen.append((full, stripped, s.draft_allowance(hi) > 0,
                     dict(slo.stats)))
    assert seen[0] == seen[1]
    assert seen[0][:3] == (2, 0, True) and seen[0][3]["degraded_drafts"] >= 1


def test_per_tenant_token_rate_fairness():
    seen = []
    for mod, s, _, slo in mk_pair(
            n_pages=32, max_batch=3,
            slo_kw=dict(tenant_rate=20.0, tenant_burst=20.0)):
        for rid, tok, tenant in ((0, 1, 0), (1, 2, 0), (2, 3, 1)):
            s.submit(mod.Request(rid=rid, prompt=[tok] * 4, max_new=8,
                                 tenant=tenant))
        a1 = _rids(s.tick().admitted)
        deferred = (s.stats["rate_deferred"], slo.stats["rate_deferred"])
        seen.append((a1, deferred, _rids(s.tick().admitted)))
    assert seen[0] == seen[1] == ([0, 2], (1, 1), [1])


def test_slo_off_is_plain_fcfs():
    seen = []
    for mod, heap in ((serve, SymmetricHeap), (jserve, JHeap)):
        kv = mod.PagedKVCache(heap(("data",), capacity_bytes=1 << 24),
                              n_layers=2, kv_heads=2, head_dim=4,
                              n_pages=32, page_tokens=4)
        s = mod.FCFSScheduler(kv, max_batch=2, max_seq=32)
        s.submit(mod.Request(rid=0, prompt=[1, 2], max_new=2,
                             priority="best_effort"))
        s.submit(mod.Request(rid=1, prompt=[3, 4], max_new=2))
        seen.append(_rids(s.tick().admitted))
    assert seen[0] == seen[1] == [0, 1]


@pytest.mark.parametrize("n_pages,spec_k,slo_kw", [
    (9, 0, {}),
    (8, 2, {}),
    (12, 0, dict(tenant_rate=16.0, tenant_burst=24.0)),
])
def test_slo_scheduler_plans_match_reference(n_pages, spec_k, slo_kw):
    """A mixed-class trace with deadlines and tenants through both SLO
    schedulers, tick by tick, finished prompts registered as prefixes
    (later requests repeat earlier prompts): the same sheds, admissions,
    resumes, migrations, evictions, prefill chunks, pressure and policy
    counters."""
    pair = mk_pair(n_pages=n_pages, page_tokens=4, max_batch=3,
                   max_seq=48, prefill_chunk=3, spec_k=spec_k,
                   slo_kw=slo_kw)
    rng = np.random.RandomState(n_pages)
    specs = []
    for i in range(9):
        prompt = list(rng.randint(0, 100, rng.randint(2, 12)))
        if i >= 4:           # an earlier prompt again, a suffix added
            prompt = specs[i - 4]["prompt"] + prompt[:2]
        specs.append(dict(
            rid=i, prompt=prompt,
            max_new=int(rng.randint(2, 8)), t_arrive=float(i // 2),
            priority=serve.PRIORITIES[rng.randint(3)],
            deadline=float(rng.choice([2.0, 6.0, 40.0])),
            tenant=int(rng.randint(2))))
    reqs = [[mod.Request(**sp) for sp in specs] for mod, *_ in pair]
    pending = [list(r) for r in reqs]
    sheds = evictions = 0
    for tick in range(300):
        if not pair[1][1].has_work() and not pending[1]:
            break
        plans = []
        for k, (mod, s, kv, slo) in enumerate(pair):
            while pending[k] and pending[k][0].t_arrive <= tick:
                s.submit(pending[k].pop(0))
            plan = s.tick(tick)
            plans.append(plan)
            chunked = {r.rid for r, _ in plan.prefill}
            for r, n in plan.prefill:
                s.note_chunk(r, n, 42 + r.rid, tick)
            for r in list(s.running):
                if r.rid not in chunked and not r.is_prefilling():
                    for _ in range(1 + s.draft_allowance(r)):
                        if not r.finished():
                            s.advance(r, 7, tick)
                if not r.is_prefilling() and r.finished():
                    s.finish(r, tick, register_prefix=True)
        a, b = plans
        for f in ("admitted", "preempted", "shed", "resumed"):
            assert _rids(getattr(a, f)) == _rids(getattr(b, f)), (tick, f)
        assert [(r.rid, n) for r, n in a.prefill] == \
            [(r.rid, n) for r, n in b.prefill]
        assert [tuple(vars(m).values()) for m in a.migrations] == \
            [tuple(vars(m).values()) for m in b.migrations]
        assert pair[0][3].pressure == pair[1][3].pressure
        assert pair[0][2].tables == pair[1][2].tables
        sheds += len(b.shed)
        evictions += len(b.preempted)
    assert not pair[0][1].has_work()
    assert pair[0][3].stats == pair[1][3].stats
    for k in pair[0][1].stats:
        assert pair[0][1].stats[k] == pair[1][1].stats[k], k
    assert pair[0][2].stats == {k: pair[1][2].stats[k]
                                for k in pair[0][2].stats}
    assert sheds + evictions > 0, "the trace must exercise the policy"


# ======================================================================
# traffic: SLO draws ride a separate stream (the port's traffic module)
# ======================================================================
def test_slo_traffic_never_shifts_classic_draws():
    plain = serve.TrafficConfig(n_requests=12, seed=3)
    mixed = serve.TrafficConfig(n_requests=12, seed=3,
                                interactive_frac=0.4, batch_frac=0.3,
                                deadline_interactive=5.0,
                                deadline_best_effort=20.0, n_tenants=3)
    a, b = serve.make_requests(plain), serve.make_requests(mixed)
    for ra, rb in zip(a, b):
        assert ra.prompt == rb.prompt
        assert ra.t_arrive == rb.t_arrive and ra.max_new == rb.max_new
    assert len({r.priority for r in b}) >= 2
    assert len({r.tenant for r in b}) >= 2
    assert all(r.priority == "interactive" and r.tenant == 0 for r in a)


def test_slo_traffic_is_prefix_stable():
    kw = dict(seed=1, interactive_frac=0.5, batch_frac=0.25, n_tenants=2)
    small = serve.make_requests(serve.TrafficConfig(n_requests=8, **kw))
    big = serve.make_requests(serve.TrafficConfig(n_requests=16, **kw))
    for ra, rb in zip(small, big):
        assert (ra.priority, ra.deadline, ra.tenant) == \
            (rb.priority, rb.deadline, rb.tenant)


# ======================================================================
# the engine under SLO traffic: the reference's sheds and streams
# ======================================================================
@pytest.fixture(scope="module")
def weights():
    jcfg = jconfigs.get_smoke("qwen3-8b")
    ctx = ParallelCtx(dp_size=1, tp_size=1, sp=False, remat=False,
                      param_dtype=jnp.float32, compute_dtype=jnp.float32)
    jparams = registry.build(jcfg).init(jax.random.PRNGKey(0), jcfg, ctx)
    return (jcfg, ctx, jparams, configs.get_smoke("qwen3-8b"),
            from_jax(jax.tree.map(np.asarray, jparams)))


def _overload(mod, vocab):
    return [mod.Request(
        rid=i, prompt=[(3 * i + j) % vocab for j in range(6)], max_new=6,
        t_arrive=0.0, priority="interactive" if i % 2 == 0 else "best_effort",
        deadline=200.0 if i % 2 == 0 else 4.0) for i in range(10)]


def _engines(weights, slo_kw, **kw):
    jcfg, ctx, jparams, cfg, params = weights
    base = dict(page_tokens=4, n_pages=16, max_batch=2, max_seq=32,
                prefill_chunk=4)
    base.update(kw)
    jeng = jserve.ServeEngine(jparams, jcfg, ctx, jserve.ServeConfig(
        attn_impl="ref", slo=jserve.SLOConfig(**slo_kw), **base))
    eng = serve.ServeEngine(params, cfg, serve.ServeConfig(
        slo=serve.SLOConfig(**slo_kw), **base), device="cpu")
    return jeng, eng


@pytest.fixture(scope="module")
def overload_runs(weights):
    jeng, eng = _engines(weights, {})
    jdone = jeng.run(_overload(jserve, weights[0].vocab), clock="tick")
    done = eng.run(_overload(serve, weights[3].vocab), clock="tick")
    return jeng, jdone, eng, done


def test_engine_sheds_best_effort_keeps_interactive(overload_runs):
    """Overload on the tick clock: best-effort traffic sheds while every
    interactive request keeps its TTFT deadline — the reference's
    summary, streams and sheds."""
    jeng, jdone, eng, done = overload_runs
    m, jm = eng.metrics(), jeng.metrics()
    assert m["slo"] == jm["slo"]
    assert m["slo"]["shed"]["best_effort"] > 0
    assert m["slo"]["shed"]["interactive"] == 0
    assert m["slo"]["attained"]["interactive"] == 1.0
    assert len(done) + len(eng.shed) == 10
    assert {r.rid: r.out for r in done} == {r.rid: r.out for r in jdone}
    assert _rids(eng.shed) == _rids(jeng.shed)
    assert eng.ticks == jeng.ticks
    assert m["sched"] == {k: jm["sched"][k] for k in m["sched"]}


def test_slo_summary_matches_reference(overload_runs):
    jeng, jdone, eng, done = overload_runs
    pol = dict(eng.slo.stats)
    assert serve.slo_summary(done, eng.shed, pol) == \
        jserve.engine.slo_summary(jdone, jeng.shed, pol)
    assert "policy" not in serve.slo_summary(done, [])


def test_engine_slo_with_eviction_and_spec_matches_reference(weights):
    """A tight pool (eviction is inverse-priority) with speculation and
    tenant fairness on: the same streams, sheds and summary."""
    slo_kw = dict(tenant_rate=30.0, tenant_burst=40.0)
    jeng, eng = _engines(weights, slo_kw, n_pages=10, max_batch=3,
                         spec_k=2)
    reqs = {}
    for mod, vocab in ((jserve, weights[0].vocab), (serve, weights[3].vocab)):
        reqs[mod] = [mod.Request(
            rid=i, prompt=[(5 * i + j) % vocab for j in range(5 + i % 3)],
            max_new=7, t_arrive=float(i // 3),
            priority=("interactive", "batch", "best_effort")[i % 3],
            deadline=(50.0, 50.0, 6.0)[i % 3], tenant=i % 2)
            for i in range(9)]
    jdone = jeng.run(reqs[jserve], clock="tick")
    done = eng.run(reqs[serve], clock="tick")
    assert {r.rid: r.out for r in done} == {r.rid: r.out for r in jdone}
    m, jm = eng.metrics(), jeng.metrics()
    assert m["slo"] == jm["slo"] and m["spec"] == jm["spec"]
    assert m["sched"] == {k: jm["sched"][k] for k in m["sched"]}
    assert m["sched"]["preempted"] + m["sched"]["shed"] > 0


def test_metrics_reset_clears_the_policy(weights):
    _, eng = _engines(weights, {})
    eng.run(_overload(serve, weights[3].vocab)[:4], clock="tick")
    eng.reset_metrics()
    assert eng.shed == [] and all(v == 0 for v in eng.slo.stats.values())
    assert eng.metrics()["slo"]["attained"]["interactive"] == 1.0


def test_cli_slo_serves_the_smoke_config_on_cpu(capsys):
    launch.main(["--config", "smoke", "--device", "cpu", "--dtype", "f32",
                 "--requests", "4", "--page-tokens", "4", "--n-pages", "32",
                 "--max-batch", "2", "--prefill-chunk", "4", "--slo",
                 "0.5+0.25", "--ttft", "2", "--tenants", "2",
                 "--tenant-rate", "60"])
    out = capsys.readouterr().out
    assert "slo=0.5+0.25" in out and '"attained"' in out
    with pytest.raises(SystemExit):
        launch.parse_slo("0.8+0.5")
    assert launch.parse_slo("0.5+0.25") == (0.5, 0.25)
