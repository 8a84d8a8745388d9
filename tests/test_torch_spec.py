"""repro_torch speculative decoding against the JAX reference: the
proposers (n-gram, replay, fixed, draft model), the window sampler, the
scheduler's draft allowance and budget, and the engine's verify path —
the port on the CPU, the reference with ``attn_impl="ref"``, the same
``from_jax`` weights and requests.

Mirrors every case of ``tests/test_spec.py``: the port's spec streams,
tick counts and ``metrics()["spec"]`` must EQUAL the JAX spec engine's
on the same requests, and its streams the JAX non-spec engine's.
Nothing here has a tolerance.
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
from repro.serve import sampling as jsampling
from repro_torch import configs, serve
from repro_torch.core.heap import SymmetricHeap
from repro_torch.kernels import ops
from repro_torch.weights import from_jax

torch.set_num_threads(2)

PATTERN = [5, 17, 42]
SAMPLED = dict(temperature=0.8, top_k=5, top_p=0.9)


def _ctx():
    return ParallelCtx(dp_size=1, tp_size=1, sp=False, remat=False,
                       param_dtype=jnp.float32, compute_dtype=jnp.float32)


def _init(arch, seed):
    jcfg = jconfigs.get_smoke(arch)
    jparams = registry.build(jcfg).init(jax.random.PRNGKey(seed), jcfg,
                                        _ctx())
    return (jcfg, jparams, configs.get_smoke(arch),
            from_jax(jax.tree.map(np.asarray, jparams)))


@pytest.fixture(scope="module")
def model():
    return _init("qwen3-8b", 0)


def _scfg(mod, spec_k, **kw):
    base = dict(page_tokens=4, n_pages=48, max_batch=3, max_seq=32,
                attn_impl="ref" if mod is jserve else "kernel")
    base.update(kw)
    return mod.ServeConfig(spec_k=spec_k, **base)


def _repeated(mod, sampled=False, max_new=16):
    """The repeated-prompt workload: periodic prompts that drive the
    greedy model into self-repetition (the n-gram proposer's case)."""
    sp = mod.SamplingParams(**SAMPLED) if sampled else mod.GREEDY
    return [mod.Request(rid=i, prompt=(PATTERN * 4)[:12 - i],
                        max_new=max_new, sampling=sp) for i in range(3)]


def _kv(mod, heap, cfg, scfg):
    return mod.PagedKVCache(heap, n_layers=cfg.n_layers,
                            kv_heads=cfg.kv_per_rank(1),
                            head_dim=cfg.head_dim, n_pages=scfg.n_pages,
                            page_tokens=scfg.page_tokens)


def _run(model, mod, spec_k, reqs, proposer=None, kv=None, **kw):
    jcfg, jparams, cfg, params = model
    scfg = _scfg(mod, spec_k, **kw)
    if mod is jserve:
        eng = jserve.ServeEngine(jparams, jcfg, _ctx(), scfg,
                                 proposer=proposer, kv=kv)
    else:
        eng = serve.ServeEngine(params, cfg, scfg, device="cpu",
                                proposer=proposer, kv=kv)
    done = eng.run(reqs, clock="tick")
    return {r.rid: list(r.out) for r in done}, eng


_CACHE: dict = {}


def _jax_plain(model, key, reqs_of, **kw):
    """The reference's NON-speculative streams, run once per module."""
    if key not in _CACHE:
        _CACHE[key] = _run(model, jserve, 0, reqs_of(jserve), **kw)[0]
    return _CACHE[key]


def _same_spec_run(jeng, teng):
    """The two engines made the same decisions: ticks, spec counters,
    scheduler and KV counters."""
    assert teng.ticks == jeng.ticks
    assert teng.metrics()["spec"] == jeng.metrics()["spec"]
    for k in teng.sched.stats:
        assert teng.sched.stats[k] == jeng.sched.stats[k], k
    for k in teng.kv.stats:
        assert teng.kv.stats[k] == jeng.kv.stats[k], k


# ======================================================================
# proposers (host-side units): same proposals as the reference's
# ======================================================================
def _both(fn):
    return fn(serve), fn(jserve)


@pytest.mark.parametrize("allow", [3, 2, 0])
def test_ngram_proposes_repeated_continuation(allow):
    def go(mod):
        r = mod.Request(rid=0, prompt=[1, 2, 3, 1, 2, 3, 1, 2], max_new=8)
        return mod.NgramProposer(min_n=1, max_n=3).propose([r], [allow])
    ours, ref = _both(go)
    assert ours == ref == [[3, 1, 2][:allow]]


def test_ngram_uses_generated_history_and_longest_match():
    def go(mod):
        r = mod.Request(rid=0, prompt=[7, 8], max_new=8)
        r.out = [9, 4, 9, 4, 9]
        return mod.NgramProposer(min_n=1, max_n=3).propose([r], [2])
    ours, ref = _both(go)
    assert ours == ref == [[4, 9]]


def test_ngram_no_match_means_no_drafts():
    def go(mod):
        r = mod.Request(rid=0, prompt=[1, 2, 3, 4, 5], max_new=4)
        return mod.NgramProposer().propose([r], [3])
    ours, ref = _both(go)
    assert ours == ref == [[]]
    with pytest.raises(ValueError):
        serve.NgramProposer(min_n=3, max_n=2)


def test_replay_and_fixed_proposers():
    def go(mod):
        r = mod.Request(rid=0, prompt=[1], max_new=8)
        r.out = [10, 11]
        return (mod.ReplayProposer({0: [10, 11, 12, 13]}).propose([r], [3]),
                mod.FixedProposer([99, 98, 97]).propose([r], [2]))
    ours, ref = _both(go)
    assert ours == ref == ([[12, 13]], [[99, 98]])


def test_make_proposer_registry():
    assert isinstance(serve.make_proposer("ngram"), serve.NgramProposer)
    with pytest.raises(ValueError):
        serve.make_proposer("nope")


# ======================================================================
# the window sampler: the reference's draws, row for row
# ======================================================================
@pytest.mark.parametrize("seed", [0, 1])
def test_sample_window_tokens_equals_reference(seed):
    rng = np.random.RandomState(seed)
    b, c, v = 3, 4, 50
    logits = rng.randn(b, c, v).astype(np.float32) * 3
    logits[0, 1, [7, 9]] = 10.0                     # a tie: lowest index
    reqs = [serve.Request(rid=r, prompt=[1], max_new=4, sampling=sp)
            for r, sp in ((0, serve.GREEDY),
                          (5, serve.SamplingParams(**SAMPLED)),
                          (9, serve.SamplingParams(temperature=1.3)))]
    st = serve.batch_state(reqs, b, 11)
    pos = (np.arange(c)[None] + np.array([3, 8, 20])[:, None] + 1) \
        .astype(np.int32)
    got = serve.sample_window_tokens(torch.from_numpy(logits), st,
                                     torch.from_numpy(pos), n_candidates=8)
    want = jsampling.sample_window_tokens(
        jnp.asarray(logits), _ctx(), {k: jnp.asarray(a)
                                      for k, a in st.items()},
        jnp.asarray(pos), n_candidates=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[0, 1]) == 7
    # row j of a window draws what a decode step at that position draws
    row = serve.sample_tokens(torch.from_numpy(logits[:, 2]), st,
                              torch.from_numpy(pos[:, 2]), n_candidates=8)
    np.testing.assert_array_equal(row.numpy(), got[:, 2].numpy())


# ======================================================================
# lossless acceptance: the reference's streams, ticks and counters
# ======================================================================
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_spec_streams_equal_jax_engine(model, sampled):
    want = _jax_plain(model, ("rep", sampled),
                      lambda m: _repeated(m, sampled))
    jgot, jeng = _run(model, jserve, 3, _repeated(jserve, sampled))
    got, eng = _run(model, serve, 3, _repeated(serve, sampled))
    assert got == jgot == want
    _same_spec_run(jeng, eng)
    sp = eng.metrics()["spec"]
    assert sp["drafted"] > 0
    if not sampled:
        # the repeated-prompt workload must actually speculate and win
        assert sp["accept_rate"] > 0 and sp["tokens_per_tick"] > 1
    assert eng.steps["verify"] == sp["verify_ticks"] > 0
    assert eng.steps["decode"] == 0          # verify replaces decode


def test_spec_sampled_alone_equals_batched(model):
    """Batch-composition invariance survives speculation."""
    full, _ = _run(model, serve, 3, _repeated(serve, sampled=True))

    def alone(mod):
        return [mod.Request(rid=1, prompt=(PATTERN * 4)[:11], max_new=16,
                            sampling=mod.SamplingParams(**SAMPLED))]
    got, _ = _run(model, serve, 3, alone(serve))
    jgot, _ = _run(model, jserve, 3, alone(jserve))
    assert got[1] == jgot[1] == full[1]


def test_replay_oracle_accepts_everything(model):
    want = _jax_plain(model, ("rep", False), lambda m: _repeated(m))
    jgot, jeng = _run(model, jserve, 3, _repeated(jserve),
                      proposer=jserve.ReplayProposer(want))
    got, eng = _run(model, serve, 3, _repeated(serve),
                    proposer=serve.ReplayProposer(want))
    assert got == jgot == want
    _same_spec_run(jeng, eng)
    sp = eng.metrics()["spec"]
    assert sp["accept_rate"] == 1.0
    assert sp["drafted"] == sp["accepted"] > 0
    assert sp["tokens_per_tick"] > 2


def test_adversarial_proposer_rejects_and_rewinds(model):
    """Every draft wrong, with page_tokens=2 so a k=3 window crosses
    page boundaries: one real token per pass, pages rewound."""
    want = _jax_plain(model, ("rep", False), lambda m: _repeated(m))
    jgot, jeng = _run(model, jserve, 3, _repeated(jserve), page_tokens=2,
                      proposer=jserve.FixedProposer([101, 102, 103]))
    got, eng = _run(model, serve, 3, _repeated(serve), page_tokens=2,
                    proposer=serve.FixedProposer([101, 102, 103]))
    assert got == jgot == want
    _same_spec_run(jeng, eng)
    sp = eng.metrics()["spec"]
    assert sp["accepted"] == 0 and sp["drafted"] > 0
    assert sp["tokens_per_tick"] == 1.0
    assert eng.kv.stats["rewound_pages"] > 0


def test_empty_proposals_degenerate_to_plain_decode(model):
    """The base proposer never proposes: n_tok = 1 everywhere, plain
    decode through the verify window, in as many ticks as without
    speculation (tick_tokens pinned equal)."""
    want, base = _run(model, serve, 0, _repeated(serve), tick_tokens=11)
    jgot, jeng = _run(model, jserve, 3, _repeated(jserve), tick_tokens=11,
                      proposer=jserve.SpecProposer())
    got, eng = _run(model, serve, 3, _repeated(serve), tick_tokens=11,
                    proposer=serve.SpecProposer())
    assert got == jgot == want
    _same_spec_run(jeng, eng)
    assert eng.ticks == base.ticks
    assert eng.spec_stats["drafted"] == 0
    assert eng.kv.stats["rewound_pages"] == 0


def test_spec_composes_with_preemption_and_chunked_prefill(model):
    def reqs(mod):
        return [mod.Request(rid=i, prompt=list(range(2 + i, 10 + i)),
                            max_new=8) for i in range(3)]
    want = _jax_plain(model, "preempt", reqs)
    jgot, jeng = _run(model, jserve, 3, reqs(jserve), n_pages=8,
                      prefill_chunk=3)
    got, eng = _run(model, serve, 3, reqs(serve), n_pages=8,
                    prefill_chunk=3)
    assert got == jgot == want
    _same_spec_run(jeng, eng)
    assert eng.sched.stats["preempted"] > 0


@pytest.mark.parametrize("proposer", ["ngram", "replay", "fixed", "none"])
def test_target_tokens_do_not_depend_on_the_proposer(model, proposer):
    """What the card checks bit for bit: the verify window is always
    k+1 wide, only n_tok differs, so the streams are the proposer's to
    speed up, never to change."""
    want = _jax_plain(model, ("rep", True), lambda m: _repeated(m, True))
    prop = {"ngram": None, "replay": serve.ReplayProposer(want),
            "fixed": serve.FixedProposer([0, 1, 2, 3]),
            "none": serve.SpecProposer()}[proposer]
    got, eng = _run(model, serve, 4, _repeated(serve, True), proposer=prop)
    assert got == want
    assert eng.spec_stats["verify_ticks"] > 0


def test_verify_windows_go_through_the_prefill_kernel_path(model,
                                                           monkeypatch):
    """Every verify window is one ``paged_prefill_attention`` call of
    k+1 rows per layer with the configured impl; no decode call."""
    calls = []
    real = ops.paged_prefill_attention

    def spy(q, *a, **kw):
        calls.append((int(q.shape[1]), kw.get("impl")))
        return real(q, *a, **kw)

    monkeypatch.setattr(ops, "paged_prefill_attention", spy)
    monkeypatch.setattr(ops, "paged_attention", None)    # never called
    _, eng = _run(model, serve, 2, [serve.Request(
        rid=0, prompt=PATTERN * 3, max_new=6)], prefill_chunk=4)
    n_layers = model[2].n_layers
    widths = [c for c, _ in calls]
    assert widths.count(3) == n_layers * eng.steps["verify"] > 0
    assert widths.count(4) == n_layers * eng.steps["prefill"]
    assert {impl for _, impl in calls} == {"kernel"}


# ======================================================================
# model-backed drafting
# ======================================================================
def _draft_pair(model, draft, spec_k, max_new):
    """The JAX and the port's engines, each with a DraftModelProposer of
    ``draft`` = (jcfg, jparams, cfg, params) over a shared cache."""
    jcfg, jparams, cfg, params = model
    djcfg, djparams, dcfg, dparams = draft
    out = []
    for mod in (jserve, serve):
        scfg = _scfg(mod, spec_k)
        if mod is jserve:
            kv = _kv(jserve, JHeap(("data",)), jcfg, scfg)
            prop = jserve.DraftModelProposer(djparams, djcfg, _ctx(), scfg,
                                             kv, target_vocab=jcfg.vocab)
        else:
            kv = _kv(serve, SymmetricHeap(("data",)), cfg, scfg)
            prop = serve.DraftModelProposer(dparams, dcfg, scfg, kv,
                                            target_vocab=cfg.vocab,
                                            device="cpu")
        out.append(_run(model, mod, spec_k, _repeated(mod, max_new=max_new),
                        proposer=prop, kv=kv) + (prop,))
    return out


def test_spec_with_draft_model_same_params_is_oracle(model):
    """A draft with the target's own params drafts what the target
    greedily emits: every draft accepted, the stream untouched."""
    want = _jax_plain(model, ("rep", False), lambda m: _repeated(m))
    (jgot, jeng, _), (got, eng, prop) = _draft_pair(model, model, 3, 16)
    assert got == jgot == want
    _same_spec_run(jeng, eng)
    sp = eng.metrics()["spec"]
    assert sp["accept_rate"] == 1.0 and sp["tokens_per_tick"] > 2
    assert prop.steps["prefill"] > 0 and prop.steps["decode"] > 0
    assert prop.pool.shape[2] == model[2].n_layers


def test_spec_with_mismatched_draft_model_still_lossless(model):
    """A different-family random draft (gemma-2b-smoke) gets little
    accepted — and the streams do not move."""
    gemma = _init("gemma-2b", 1)
    assert gemma[2].vocab == model[2].vocab
    want = _jax_plain(model, ("rep8", False),
                      lambda m: _repeated(m, max_new=8))
    (jgot, jeng, _), (got, eng, prop) = _draft_pair(model, gemma, 2, 8)
    assert got == jgot == want
    _same_spec_run(jeng, eng)
    assert eng.spec_stats["drafted"] > 0
    assert prop.pool.shape[2:] == (gemma[2].n_layers, 4,
                                   gemma[2].kv_per_rank(1),
                                   gemma[2].head_dim)


def test_draft_model_vocab_mismatch_rejected(model):
    _, _, cfg, params = model
    scfg = _scfg(serve, 2)
    kv = _kv(serve, SymmetricHeap(("data",)), cfg, scfg)
    with pytest.raises(ValueError, match="vocab"):
        serve.DraftModelProposer(params, cfg, scfg, kv,
                                 target_vocab=cfg.vocab + 1, device="cpu")


# ======================================================================
# scheduler accounting under speculation: the reference's decisions
# ======================================================================
def _sched_pair(n_pages, **kw):
    out = []
    for mod, heap in ((serve, SymmetricHeap), (jserve, JHeap)):
        kv = mod.PagedKVCache(heap(("data",), capacity_bytes=1 << 24),
                              n_layers=1, kv_heads=1, head_dim=4,
                              n_pages=n_pages, page_tokens=4)
        out.append((mod, mod.FCFSScheduler(kv, **kw)))
    return out


def test_draft_allowance_caps_at_output_budget():
    seen = []
    for mod, s in _sched_pair(16, max_batch=2, max_seq=32, spec_k=4):
        r = mod.Request(rid=0, prompt=[1, 2], max_new=3)
        s.submit(r)
        s.tick()
        s.note_prefilled(r, 9)              # out = [9], 2 tokens left
        a1 = s.draft_allowance(r)
        r.out.append(8)                     # 1 token left
        r2 = mod.Request(rid=1, prompt=[1], max_new=31)
        seen.append((a1, s.draft_allowance(r), s.draft_allowance(r2)))
    assert seen[0] == seen[1] == (1, 0, 0)


def test_spec_budget_claims_verify_window():
    """A decoding sequence claims 1 + allowance tokens of the budget, so
    prefill chunks shrink (decode first); the default budget scales
    with the window."""
    seen = []
    for mod, s in _sched_pair(32, max_batch=4, max_seq=64, spec_k=3,
                              prefill_chunk=4, tick_tokens=6):
        r0 = mod.Request(rid=0, prompt=[1, 2], max_new=8)
        s.submit(r0)
        s.tick()
        s.note_prefilled(r0, 9)
        s.submit(mod.Request(rid=1, prompt=list(range(10)), max_new=4))
        plan = s.tick()
        s2 = mod.FCFSScheduler(s.kv, max_batch=4, max_seq=64, spec_k=3,
                               prefill_chunk=4)
        seen.append(([(r.rid, n) for r, n in plan.prefill], s2.tick_tokens))
    assert seen[0] == seen[1] == ([(1, 2)], 4 * (1 + 3) + 4)
