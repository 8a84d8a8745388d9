"""repro_torch MoE serving against the JAX reference at the smoke sizes
of both MoE archs (qwen3-moe-30b-a3b: 8 experts, top-2, GQA, qk_norm;
qwen2-moe-a2.7b: 6 experts padded to 8, top-2, a shared expert, MHA):
the configs, ``lm.init``'s tree, ``from_jax`` on every MoE leaf, the
router, the capacity slots and ``moe_apply`` (the reference's
``moe_apply`` at tp = 1 on the same weights and numpy-seeded inputs),
and the whole engine's token streams (the port on the CPU, the
reference with ``attn_impl="ref"``).

The smoke configs set ``capacity_factor=8.0``, so nothing is dropped;
cases with 1.25 (the published default) and 1.0 drop pairs, and there
the keep masks and the streams must still EQUAL the reference's, each
run against its own JAX twin: under drops a stream depends on what
shares a step (speculation, chunking and prefix resume change that), in
the reference as in the port.  ``moe_apply`` is held to 1e-5 in f32
(matrix products summed in another order) and, in bf16 compute, to
2^-7 of its largest output on the rows whose routing agrees (a row may
route otherwise only at a near-tie); routing, slots and streams have no
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
from repro.models import mlp as jmlp
from repro.models import registry
from repro.parallel.ctx import ParallelCtx
from repro_torch import configs, serve
from repro_torch.core.heap import SymmetricHeap
from repro_torch.launch import serve as launch
from repro_torch.models import lm, mlp
from repro_torch.weights import from_jax

torch.set_num_threads(2)

ARCHS = ["qwen3-moe-30b-a3b", "qwen2-moe-a2.7b"]
PATTERN = [5, 17, 42]
PROMPTS = [list(range(3, 9)), list(range(4, 10)), [7, 3, 99, 12]]
SAMPLED = dict(temperature=0.9, top_k=5, top_p=0.9)


def _ctx(compute_dtype=jnp.float32):
    return ParallelCtx(dp_size=1, tp_size=1, sp=False, remat=False,
                       param_dtype=jnp.float32, compute_dtype=compute_dtype)


def _with_cf(cfg, cf):
    """``cfg`` with the MoE capacity factor ``cf`` (None: unchanged)."""
    if cf is None:
        return cfg
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(arch, JAX cfg, JAX params, port cfg, port params) at the smoke
    size, the port's weights handed over from the JAX init."""
    arch = request.param
    jcfg = jconfigs.get_smoke(arch)
    jparams = registry.build(jcfg).init(jax.random.PRNGKey(0), jcfg, _ctx())
    return (arch, jcfg, jparams, configs.get_smoke(arch),
            from_jax(jax.tree.map(np.asarray, jparams)))


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


# ======================================================================
# configs, init, weights
# ======================================================================
@pytest.mark.parametrize("arch", ARCHS)
def test_config_copies_match_reference(arch):
    for get in ("get", "get_smoke"):
        assert dataclasses.asdict(getattr(configs, get)(arch)) == \
            dataclasses.asdict(getattr(jconfigs, get)(arch))


def _flat(tree, path=""):
    """{dotted key: leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}{k}."))
        return out
    return {path[:-1]: tree}


def _jax_tree(arch, config):
    """{dotted key: (shape, dtype)} of the reference's init pytree, by
    ``jax.eval_shape``: nothing is drawn, so the full width costs no
    memory."""
    jcfg = (jconfigs.get_smoke if config == "smoke" else jconfigs.get)(arch)
    init = registry.build(jcfg).init
    tree = jax.eval_shape(lambda k: init(k, jcfg, _ctx()),
                          jax.random.PRNGKey(0))
    return {k: (tuple(v.shape), str(v.dtype)) for k, v in _flat(tree).items()}


def _port_block_tree(cfg):
    """{dotted key: (shape, dtype)} of ``lm.init``'s stacked blocks from
    its shape table (f32, the reference's param dtype here); an entry
    is a shape or a (shape, init scale) pair."""
    return {f"blocks.{k}": ((cfg.n_layers,)
                            + tuple(v[0] if isinstance(v[0], tuple) else v),
                            "float32")
            for k, v in _flat(lm._block_shapes(cfg)).items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_block_shapes_equal_the_reference_pytree(arch):
    """At the published widths (qwen3-moe: 128 experts of (2048, 768);
    qwen2-moe: 64 padded experts of (2048, 1408) and a 5632 shared
    expert) the port's block shapes are the reference pytree's."""
    want = {k: v for k, v in _jax_tree(arch, "full").items()
            if k.startswith("blocks.")}
    assert _port_block_tree(configs.get(arch)) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_equals_the_reference_pytree(arch):
    """``lm.init``'s keys, shapes and dtypes equal the JAX pytree's at
    the smoke size, with the reference's distributions: the router's
    scale 0.02, an expert tensor's 1/sqrt(E) (fan_in = shape[0], the
    expert count)."""
    cfg = configs.get_smoke(arch)
    params = lm.init(torch.Generator().manual_seed(0), cfg)
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
           for k, v in _flat(params).items()}
    assert got == _jax_tree(arch, "smoke")
    m, e = params["blocks"]["mlp"], cfg.moe.experts_padded(1)
    assert e == (cfg.moe.padded_experts or cfg.moe.num_experts)
    assert abs(float(m["router"].std()) - 0.02) < 0.004
    assert abs(float(m["wu"].std()) - e ** -0.5) < 0.02
    assert abs(float(m["wd"].std()) - e ** -0.5) < 0.02
    assert ("shared" in m) == bool(cfg.moe.shared_ff)
    bf = lm.init(torch.Generator().manual_seed(0), cfg, dtype=torch.bfloat16)
    assert bf["blocks"]["mlp"]["wg"].dtype == torch.bfloat16


def test_from_jax_round_trips_every_moe_leaf(model):
    _, jcfg, jparams, _, params = model
    jflat = _flat(jax.tree.map(np.asarray, jparams))
    flat = _flat(params)
    assert set(flat) == set(jflat)
    for k, v in jflat.items():
        assert flat[k].dtype == torch.float32
        np.testing.assert_array_equal(flat[k].numpy(), v, err_msg=k)
    moe = {k.split(".", 2)[2] for k in flat if k.startswith("blocks.mlp.")}
    want = {"router", "wu", "wg", "wd"}
    if jcfg.moe.shared_ff:
        want |= {"shared.wu", "shared.wg", "shared.wd"}
    assert moe == want
    bad = jax.tree.map(np.asarray, jparams)
    bad["blocks"]["mlp"]["gate_bias"] = np.zeros(3, np.float32)
    with pytest.raises(NotImplementedError, match="gate_bias"):
        from_jax(bad)


# ======================================================================
# router, capacity slots, moe_apply
# ======================================================================
def _inputs(cfg, b, t, seed):
    return np.random.RandomState(seed).randn(b, t, cfg.d_model).astype(
        np.float32)


def _jax_routing(p, xt, jcfg):
    gate, idx, _ = jmlp._route(jnp.asarray(p["router"]), jnp.asarray(xt),
                               jcfg, jnp.float32)
    pos = jmlp._positions_in_expert(idx, jcfg.moe.experts_padded(1))
    return np.asarray(gate), np.asarray(idx), np.asarray(pos)


@pytest.mark.parametrize("cf", [None, 1.25, 1.0])
def test_moe_apply_matches_reference(model, cf):
    """Same weights, same inputs: ``moe_apply`` within 1e-5 of the
    reference's, the routing, slots and keep mask EQUAL.  Each of the 4
    rows of 16 tokens ends in 6 copies of one token, as a window's
    padded tail does in the engine, so 24 tokens route alike: the smoke
    factor 8.0 keeps every pair; 1.25 and 1.0 drop some."""
    arch, jcfg, jparams, cfg, params = model
    jcfg, cfg = _with_cf(jcfg, cf), _with_cf(cfg, cf)
    jp = _layer0(jparams["blocks"]["mlp"])
    tp = lm.layer(params["blocks"], 0)["mlp"]
    x = _inputs(cfg, 4, 16, seed=3)
    x[:, 10:] = x[0, 0]
    want = jmlp.moe_apply(jp, jnp.asarray(x), _ctx(), jcfg)
    got = mlp.moe_apply(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)

    xt = x.reshape(-1, cfg.d_model)
    jgate, jidx, jpos = _jax_routing(jp, xt, jcfg)
    gate, idx = mlp.route(tp["router"], torch.from_numpy(xt), cfg)
    pos = mlp.positions_in_expert(idx, cfg.moe.experts_padded(1))
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_allclose(gate.numpy(), jgate, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(pos.numpy(), jpos)
    m = cfg.moe
    cap = int(xt.shape[0] * m.top_k * m.capacity_factor
              / m.experts_padded(1)) + 1
    dropped = int((pos >= cap).sum())
    if cf is None:
        assert dropped == 0
    else:
        assert dropped > 0, f"cf {cf}: nothing dropped at capacity {cap}"


@pytest.mark.parametrize("cf", [None, 1.25, 1.0])
def test_moe_apply_bf16_matches_reference(model, cf):
    """bf16 compute on both sides (the port's default serving dtype): the
    same inputs as the f32 case, in bf16.  A row may route otherwise only
    at a near-tie (the k-th and (k+1)-th logits within 4 bf16 ulps: each
    side rounds its f32-accumulated logits to bf16, so each logit may
    move by one ulp); the keep masks are equal up to the first such row
    (a flip moves later rows' slots only); and every row whose routing
    and keep mask are equal is within 2^-7 of the reference relative to
    its output's largest value (one or two bf16 ulps there: the gate
    cast, the slot accumulation and the three products round in bf16)."""
    arch, jcfg, jparams, cfg, params = model
    jcfg, cfg = _with_cf(jcfg, cf), _with_cf(cfg, cf)
    jp = _layer0(jparams["blocks"]["mlp"])
    tp = lm.layer(params["blocks"], 0)["mlp"]
    x = _inputs(cfg, 4, 16, seed=3)
    x[:, 10:] = x[0, 0]
    want = jmlp.moe_apply(jp, jnp.asarray(x), _ctx(jnp.bfloat16), jcfg)
    assert want.dtype == jnp.bfloat16
    xb = torch.from_numpy(x).bfloat16()
    got = mlp.moe_apply(tp, xb, cfg)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32)).reshape(-1, cfg.d_model)
    got = got.float().numpy().reshape(-1, cfg.d_model)

    m, e = cfg.moe, cfg.moe.experts_padded(1)
    xt = jnp.asarray(x.reshape(-1, cfg.d_model)).astype(jnp.bfloat16)
    _, jidx, _ = jmlp._route(jnp.asarray(jp["router"]), xt, jcfg,
                             jnp.bfloat16)
    jidx = np.asarray(jidx)
    jpos = np.asarray(jmlp._positions_in_expert(jnp.asarray(jidx), e))
    logits = np.sort(np.asarray(
        (xt @ jnp.asarray(jp["router"]).astype(jnp.bfloat16))
        .astype(jnp.float32))[:, :m.num_experts], axis=1)[:, ::-1]
    lk, lk1 = logits[:, m.top_k - 1], logits[:, m.top_k]
    near = lk - lk1 < 4 * 2.0 ** -8 * np.maximum(abs(lk), abs(lk1))

    _, idx = mlp.route(tp["router"], xb.reshape(-1, cfg.d_model), cfg)
    idx = idx.numpy()
    pos = mlp.positions_in_expert(torch.from_numpy(idx), e).numpy()
    cap = int(len(idx) * m.top_k * m.capacity_factor / e) + 1
    flips = np.flatnonzero((idx != jidx).any(1))
    assert near[flips].all(), f"rows {flips} flipped away from a near-tie"
    first = flips[0] if len(flips) else len(idx)
    keep, jkeep = (pos < cap).reshape(idx.shape), (jpos < cap).reshape(
        idx.shape)
    np.testing.assert_array_equal(keep[:first], jkeep[:first])
    same = ~(idx != jidx).any(1) & ~(keep != jkeep).any(1)
    assert same.sum() >= len(idx) // 2, f"{same.sum()} rows held"
    np.testing.assert_allclose(got[same], want[same], rtol=2.0 ** -7,
                               atol=2.0 ** -7 * float(abs(want).max()))
    if cf is not None:
        assert not jkeep.all(), f"cf {cf}: nothing dropped at capacity {cap}"


def test_moe_apply_drops_in_token_major_order(model):
    """The first ``cap`` pairs routed to an expert, counted token by
    token, are the ones kept: of six copies of one token (they route
    alike) at capacity int(6 k / E) + 1 = 2, the first two get the
    routed experts and the last four only the shared expert (zero
    without one)."""
    _, _, _, cfg, params = model
    cfg = _with_cf(cfg, 1.0)
    m = cfg.moe
    assert int(6 * m.top_k / m.experts_padded(1)) + 1 == 2
    tp = lm.layer(params["blocks"], 0)["mlp"]
    row = torch.from_numpy(_inputs(cfg, 1, 1, seed=5))[0, 0]
    out = mlp.moe_apply(tp, row.expand(1, 6, cfg.d_model).contiguous(),
                        cfg)[0]
    shared = (mlp.mlp_apply(tp["shared"], row, cfg) if m.shared_ff
              else torch.zeros_like(row))
    torch.testing.assert_close(out[1], out[0], rtol=0, atol=0)
    assert not torch.allclose(out[0], shared)
    for j in range(2, 6):
        torch.testing.assert_close(out[j], shared, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("model", ["qwen2-moe-a2.7b"], indirect=True)
def test_padded_experts_receive_no_mass(model):
    """qwen2-moe pads 6 experts to 8: the router never picks a padded one,
    so the output does not move when their weights are made huge."""
    _, _, _, cfg, params = model
    m = cfg.moe
    assert m.padded_experts > m.num_experts
    tp = lm.layer(params["blocks"], 0)["mlp"]
    x = torch.from_numpy(_inputs(cfg, 3, 8, seed=7))
    gate, idx = mlp.route(tp["router"], x.reshape(-1, cfg.d_model), cfg)
    assert int(idx.max()) < m.num_experts
    noisy = {k: v.clone() for k, v in tp.items() if k != "shared"}
    noisy["shared"] = tp["shared"]
    for k in ("wu", "wg", "wd"):
        noisy[k][m.num_experts:] = 1e6
    torch.testing.assert_close(mlp.moe_apply(noisy, x, cfg),
                               mlp.moe_apply(tp, x, cfg), rtol=0, atol=0)


@pytest.mark.parametrize("tie", ["all", "pairs"])
def test_router_ties_break_to_the_lowest_index(model, tie):
    """Equal gates pick the lowest expert index, as ``jax.lax.top_k``:
    a zero router ties every expert; duplicated router columns tie
    pairs of experts."""
    arch, jcfg, _, cfg, _ = model
    e, d = cfg.moe.experts_padded(1), cfg.d_model
    rng = np.random.RandomState(11)
    if tie == "all":
        w = np.zeros((d, e), np.float32)
    else:
        w = rng.randn(d, e).astype(np.float32)
        w[:, 3] = w[:, 1]
        w[:, 5] = w[:, 0]
        w[:, 2] = w[:, 4]
    xt = rng.randn(10, d).astype(np.float32)
    _, jidx, jpos = _jax_routing({"router": w}, xt, jcfg)
    _, idx = mlp.route(torch.from_numpy(w), torch.from_numpy(xt), cfg)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_array_equal(
        mlp.positions_in_expert(idx, e).numpy(), jpos)
    if tie == "all":
        assert (idx.numpy() == np.arange(cfg.moe.top_k)).all()


# ======================================================================
# the engine: the port on the CPU vs the JAX engine
# ======================================================================
def _scfg(mod, **kw):
    base = dict(page_tokens=4, n_pages=48, max_batch=3, max_seq=40,
                attn_impl="ref" if mod is jserve else "kernel")
    base.update(kw)
    return mod.ServeConfig(**base)


def _reqs(mod, kind):
    if kind == "repeated":          # periodic prompts: n-gram drafts land
        return [mod.Request(rid=i, prompt=(PATTERN * 4)[:12 - i],
                            max_new=12) for i in range(3)]
    if kind == "sampled":
        sp = mod.SamplingParams(**SAMPLED)
        return [mod.Request(rid=0, prompt=PATTERN * 4, max_new=8),
                mod.Request(rid=1, prompt=PATTERN * 3, max_new=8,
                            sampling=sp),
                mod.Request(rid=2, prompt=[7, 3, 99, 12], max_new=8,
                            sampling=mod.SamplingParams(temperature=1.3))]
    return [mod.Request(rid=i, prompt=p, max_new=6)
            for i, p in enumerate(PROMPTS)]


def _kv(mod, heap, cfg, scfg):
    return mod.PagedKVCache(heap, n_layers=cfg.n_layers,
                            kv_heads=cfg.kv_per_rank(1),
                            head_dim=cfg.head_dim, n_pages=scfg.n_pages,
                            page_tokens=scfg.page_tokens)


def _engine(model, mod, cf=None, draft=False, **kw):
    """The reference's engine (``mod`` = jserve) or the port's on the CPU;
    ``draft`` a DraftModelProposer of the same arch with the target's
    weights over a shared cache."""
    _, jcfg, jparams, cfg, params = model
    jcfg, cfg = _with_cf(jcfg, cf), _with_cf(cfg, cf)
    scfg = _scfg(mod, **kw)
    if mod is jserve:
        kv, prop = None, None
        if draft:
            kv = _kv(jserve, JHeap(("data",)), jcfg, scfg)
            prop = jserve.DraftModelProposer(jparams, jcfg, _ctx(), scfg,
                                             kv, target_vocab=jcfg.vocab)
        eng = jserve.ServeEngine(jparams, jcfg, _ctx(), scfg, kv=kv,
                                 proposer=prop)
    else:
        kv, prop = None, None
        if draft:
            kv = _kv(serve, SymmetricHeap(("data",)), cfg, scfg)
            prop = serve.DraftModelProposer(params, cfg, scfg, kv,
                                            target_vocab=cfg.vocab,
                                            device="cpu")
        eng = serve.ServeEngine(params, cfg, scfg, device="cpu", kv=kv,
                                proposer=prop)
    return eng


def _run(model, mod, kind, cf=None, draft=False, **kw):
    """One engine run of the ``kind`` workload."""
    eng = _engine(model, mod, cf, draft, **kw)
    done = eng.run(_reqs(mod, kind), clock="tick")
    return {r.rid: list(r.out) for r in done}, eng


_JAX: dict = {}


def _jax_streams(model, kind, cf=None, draft=False, **kw):
    """The reference's streams for one configuration, run once."""
    key = (model[0], kind, cf, draft, tuple(sorted(kw.items())))
    if key not in _JAX:
        streams, eng = _run(model, jserve, kind, cf, draft, **kw)
        _JAX[key] = (streams, eng.ticks, dict(eng.spec_stats))
    return _JAX[key]


@pytest.mark.parametrize("chunk", [16, 3])
def test_engine_greedy_streams_equal_jax_engine(model, chunk):
    """Greedy streams at two prefill chunkings equal the reference's
    whole-prompt run: the smoke capacity drops nothing, so chunking
    cannot move a token."""
    want, _, _ = _jax_streams(model, "greedy", prefill_chunk=16)
    got, eng = _run(model, serve, "greedy", prefill_chunk=chunk)
    assert got == want
    assert eng.steps["prefill"] > 0 and eng.steps["decode"] > 0


def test_engine_sampled_streams_equal_jax_engine(model):
    want, _, _ = _jax_streams(model, "sampled", sample_seed=11)
    got, _ = _run(model, serve, "sampled", sample_seed=11)
    assert got == want


@pytest.mark.parametrize("how", ["ngram", "draft"])
def test_engine_spec_streams_equal_jax_engine(model, how):
    """n-gram speculation and a same-arch draft model (the target's own
    weights): the streams, ticks and spec counters equal the reference
    spec engine's, and the streams the non-spec run's."""
    kw = dict(spec_k=2, prefill_chunk=16)
    draft = how == "draft"
    want, ticks, stats = _jax_streams(model, "repeated", draft=draft, **kw)
    got, eng = _run(model, serve, "repeated", draft=draft, **kw)
    assert got == want
    assert (eng.ticks, eng.spec_stats) == (ticks, stats)
    assert stats["verify_ticks"] > 0 and stats["drafted"] > 0
    if draft:                 # the target's own weights: an oracle draft
        assert stats["accepted"] == stats["drafted"]
    plain, _, _ = _jax_streams(model, "repeated", prefill_chunk=16)
    assert got == plain


@pytest.mark.parametrize("spec_k", [0, 2])
def test_engine_streams_under_capacity_drops_equal_jax_engine(
        model, monkeypatch, spec_k):
    """The published capacity factor 1.25 at the smoke size drops pairs
    (a decode step of 3 slots gets 1 slot per expert): with and without
    speculation the port's streams equal the reference run's with the
    same settings, greedy and sampled."""
    dropped = []
    slots = mlp.positions_in_expert

    def counting(idx_k, n_experts):
        pos = slots(idx_k, n_experts)
        m = model[3].moe
        cap = int(idx_k.shape[0] * m.top_k * 1.25 / n_experts) + 1
        dropped.append(int((pos >= cap).sum()))
        return pos

    monkeypatch.setattr(mlp, "positions_in_expert", counting)
    for kind in ("repeated", "sampled"):
        kw = dict(spec_k=spec_k, prefill_chunk=16, sample_seed=11)
        want, ticks, stats = _jax_streams(model, kind, cf=1.25, **kw)
        got, eng = _run(model, serve, kind, cf=1.25, **kw)
        assert got == want, kind
        assert (eng.ticks, eng.spec_stats) == (ticks, stats)
    assert sum(dropped) > 0


def _prefix_serves(model, mod, cf):
    """The periodic prompts served twice on one ``prefix_keep`` engine,
    the second serve (rids + 10) after the first has finished: the
    streams of both, the ticks, and the kv and scheduler counters."""
    eng = _engine(model, mod, cf, prefix_keep=True, prefill_chunk=16)
    eng.run(_reqs(mod, "repeated"), clock="tick")
    again = [mod.Request(rid=10 + r.rid, prompt=list(r.prompt),
                         max_new=r.max_new) for r in _reqs(mod, "repeated")]
    done = eng.run(again, clock="tick")
    return ({r.rid: list(r.out) for r in done}, eng.ticks,
            dict(eng.kv.stats), eng.sched.stats["resumed"])


@pytest.mark.parametrize("cf", [None, 1.25])
def test_engine_prefix_resume_equals_jax_engine(model, cf):
    """``prefix_keep``: the prompts served again resume from their pinned
    pages (prefix hits, pages migrated); both serves' streams, the ticks
    and the kv counters equal the reference engine's.  At the smoke
    capacity nothing is dropped, so a resumed stream also equals its
    first serve's; at 1.25 the resumed suffix routes in other company
    (the prompt's head is not prefilled again), so it is held only to
    its JAX twin."""
    streams, ticks, kv, resumed = _prefix_serves(model, serve, cf)
    jstreams, jticks, jkv, jresumed = _prefix_serves(model, jserve, cf)
    assert streams == jstreams
    assert (ticks, resumed) == (jticks, jresumed)
    assert kv == {k: jkv[k] for k in kv}
    assert kv["prefix_hits"] >= 3 and kv["migrations"] > 0 and resumed >= 3
    if cf is None:
        assert all(streams[10 + i] == streams[i] for i in range(3))


def test_build_engine_and_cli_serve_moe(model, monkeypatch, capsys):
    """``build_engine`` and the CLI take the MoE archs: on the GPU by
    default (raising without one), on the CPU when asked."""
    arch = model[0]
    small = dict(config="smoke", dtype="f32", page_tokens=4, n_pages=16,
                 max_batch=2, prefill_chunk=4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.build_engine(arch, **small)
    eng, cfg = launch.build_engine(arch, device="cpu", spec_k=2, draft=arch,
                                   **small)
    assert cfg.moe is not None and eng.proposer.cfg == cfg
    done = eng.run([serve.Request(rid=0, prompt=PATTERN * 2, max_new=4)],
                   clock="tick")
    assert len(done[0].out) == 4
    launch.main(["--arch", arch, "--config", "smoke", "--device", "cpu",
                 "--dtype", "f32", "--requests", "2", "--page-tokens", "4",
                 "--n-pages", "32", "--max-batch", "2", "--prefill-chunk",
                 "4"])
    assert f"arch={cfg.name} device=cpu" in capsys.readouterr().out
