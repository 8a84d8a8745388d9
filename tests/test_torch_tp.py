"""Tensor-parallel serving on the stacked team (``ParallelCtx(tp_size=4)``,
``serve.StackedExec``) against the JAX reference's 8-PE mesh serving.

The reference serves on a (data 2, model 4) mesh of 8 CPU devices, which
must be set before JAX starts; so this file re-executes itself in a
subprocess (``--jax-worker``) with
``XLA_FLAGS=--xla_force_host_platform_device_count=8``, as
``test_torch_comm.py`` does.  The worker rebuilds the reference's mesh
wiring here (``MeshExec`` of the multi-PE serve suite: shard_map'd step
functions over the pool's (data, model) leading axes, migration as one
put_nbi per TP rank over the flattened team), with the step functions
compiled once per backend, and runs the smoke qwen3-8b in f32 with the
suite's ``ServeConfig(page_tokens=4, n_pages=24, max_batch=3,
max_seq=32, prefill_chunk=3)``, its PROMPTS and SAMPLED, under the
``xla`` and ``posh`` backends with ``attn_impl="ref"`` (the reference's
Pallas runs in interpret mode, minutes; it asserts pallas == posh ==
xla itself).  It writes weights, streams, pools and logits to an
``.npz``.

The port serves the same ``from_jax`` weights through ``shard_for_tp``
on a ``StackedExec`` with two replicas (DP2 x TP4) and is held, backend
for backend, to the reference's streams: port xla to reference xla, port
posh AND pallas to reference posh (the port's posh/pallas psums are the
reference's bit for bit, its xla psum within rtol 1e-6 of XLA's, so
each is held to its own twin).  Streams and token ids have no
tolerance; the first-step logits are held within 1e-5 x max |logit|,
the served pools within 1e-5 x max |pool| (page 0, the null page that
padded rows write, excluded).  The checks are the suite's seven:
backend parity (greedy and sampled), batch invariance, TP-argmax ties
across shards, replica page migration, prefix resume by migration,
speculative decoding (n-gram, replay, an adversarial proposer) and
``attn_impl="kernel"`` (on the CPU the kernels' plain versions).
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DP, TP = 2, 4
PROMPTS = [list(range(3, 11)), list(range(40, 46)), [7, 3, 99, 12, 55]]
PREFIX_PROMPT = list(range(3, 14))              # 2 full pages + 3 tokens
SCFG = dict(page_tokens=4, n_pages=24, max_batch=3, max_seq=32,
            prefill_chunk=3)
SAMPLED = dict(temperature=0.8, top_k=5, top_p=0.9)
MIG = dict(src_page=3, dst_page=9, seed=7)
# the first prefill chunk of every prompt: block tables of 2 pages each
FIRST_BT = [[1, 2] + [0] * 6, [3, 4] + [0] * 6, [5, 6] + [0] * 6]


def _stream_array(streams: dict) -> np.ndarray:
    return np.array([streams[i] for i in range(len(streams))], np.int32)


# ======================================================================
# the JAX worker (a subprocess with 8 CPU devices)
# ======================================================================
def _jax_worker(out_path: str) -> None:
    t_start = time.monotonic()
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro import compat, configs, serve
    from repro.core import CommQueue, SymmetricHeap
    from repro.core.ordering import PermuteTransport
    from repro.models import embed as emb
    from repro.models import registry
    from repro.parallel.ctx import ParallelCtx, smap
    from repro.serve.engine import _make_window_forward

    mesh = compat.make_mesh((DP, TP), ("data", "model"))
    pool_spec = P("data", "model")
    cfg = configs.get_smoke("qwen3-8b")
    api = registry.build(cfg)
    f32 = dict(param_dtype=jnp.float32, compute_dtype=jnp.float32)
    params = api.init(jax.random.PRNGKey(0), cfg,
                      ParallelCtx(dp_size=1, tp_size=1, sp=False,
                                  remat=False, **f32))

    def make_ctx(backend):
        return ParallelCtx(dp_size=DP, tp_size=TP, sp=False, remat=False,
                           backend=backend, **f32)

    steps = {}

    def jitted(backend, scfg):
        # the step functions take params and pool as arguments, so one
        # compile per backend serves every engine
        if backend not in steps:
            ctx = make_ctx(backend)
            fns = (serve.make_prefill(cfg, ctx, scfg),
                   serve.make_decode_step(cfg, ctx, scfg),
                   serve.make_verify(cfg, ctx, scfg))

            def wrap(f):
                def w(params, pool, a, b, c, d, samp):
                    toks, kvo = f(params, pool[0, 0], a, b, c, d, samp)
                    return toks, kvo[None, None]
                return jax.jit(smap(
                    w, mesh, (api.specs(cfg, ctx), pool_spec, P(), P(),
                              P(), P(), P()), (P("data"), pool_spec)))
            steps[backend] = tuple(wrap(f) for f in fns)
        return steps[backend]

    class MeshExec:
        def __init__(self, backend, scfg, kv, my_pe=0):
            self.params, self.kv, self.my_pe = params, kv, my_pe
            self._prefill, self._decode, self._verify = jitted(backend,
                                                               scfg)

        def _my_row(self, toks):
            t = np.asarray(toks)
            return t.reshape((DP, -1) + t.shape[1:])[self.my_pe]

        def init_pool(self):
            return jnp.zeros((DP, TP) + self.kv.handle.shape,
                             self.kv.handle.dtype)

        def _call(self, fn, pool, arrays, samp):
            toks, pool = fn(self.params, pool,
                            *(jnp.asarray(a) for a in arrays), samp)
            return self._my_row(toks), pool

        def prefill(self, pool, ids, start, n_tok, bt, samp):
            return self._call(self._prefill, pool, (ids, start, n_tok, bt),
                              samp)

        def decode(self, pool, tokens, pos, bt, lens, samp):
            return self._call(self._decode, pool, (tokens, pos, bt, lens),
                              samp)

        def verify(self, pool, ids, start, n_tok, bt, samp):
            return self._call(self._verify, pool, (ids, start, n_tok, bt),
                              samp)

        def migrate(self, pool, migrations):
            migs = tuple(migrations)
            kv, name = self.kv, self.kv.handle.name

            def mg(pool):
                local = pool[0, 0]
                q = CommQueue(("data", "model"), {name: local},
                              transport=PermuteTransport())
                st = kv.issue_migrations(
                    q, local, migs,
                    pairs_of=lambda m: [(m.src_pe * TP + t,
                                         m.dst_pe * TP + t)
                                        for t in range(TP)])
                assert q.stats()["quiets"] == 1
                return st[name][None, None]

            return jax.jit(smap(mg, mesh, (pool_spec,), pool_spec))(pool)

    def build(backend, *, prefix_keep=False, my_pe=0, kv=None, scfg=None):
        scfg = scfg or serve.ServeConfig(**SCFG, attn_impl="ref",
                                         prefix_keep=prefix_keep)
        if kv is None:
            kv = serve.PagedKVCache(
                SymmetricHeap(("data", "model"), capacity_bytes=1 << 30),
                n_layers=cfg.n_layers, kv_heads=cfg.kv_per_rank(TP),
                head_dim=cfg.head_dim, n_pages=scfg.n_pages,
                page_tokens=scfg.page_tokens)
        exec_ = MeshExec(backend, scfg, kv, my_pe)
        return serve.ServeEngine(params, cfg, make_ctx(backend), scfg,
                                 kv=kv, exec_=exec_, my_pe=my_pe)

    sampled = serve.SamplingParams(**SAMPLED)
    out = {f"param:{'/'.join(str(k.key) for k in path)}": np.asarray(leaf)
           for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    for backend in ("xla", "posh"):
        for tag, sp in (("greedy", serve.GREEDY), ("sampled", sampled)):
            eng = build(backend)
            done = eng.run([serve.Request(rid=i, prompt=list(p), max_new=6,
                                          sampling=sp)
                            for i, p in enumerate(PROMPTS)], clock="tick")
            out[f"streams:{backend}:{tag}"] = _stream_array(
                {r.rid: list(r.out) for r in done})
            if tag == "greedy":
                out[f"pool:{backend}"] = np.asarray(eng.pool)

    # replica page migration on replica-distinct contents
    eng = build("xla")
    rng = np.random.RandomState(MIG["seed"])
    pool = rng.randn(*np.asarray(eng.exec.init_pool()).shape)
    out["mig:out"] = np.asarray(eng.exec.migrate(
        jnp.asarray(pool.astype(np.float32)),
        [serve.PageMigration(src_pe=0, dst_pe=1, src_page=MIG["src_page"],
                             dst_page=MIG["dst_page"])]))

    # prefix resume by migration on replica 1
    scratch = build("xla").run([serve.Request(
        rid=0, prompt=list(PREFIX_PROMPT), max_new=6)], clock="tick")
    eng = build("xla", prefix_keep=True, my_pe=0)
    eng.run([serve.Request(rid=0, prompt=list(PREFIX_PROMPT), max_new=6)],
            clock="tick")
    eng2 = build("xla", my_pe=1, kv=eng.kv, scfg=eng.scfg)
    eng2.pool = eng.pool
    eng2.submit(serve.Request(rid=100, prompt=list(PREFIX_PROMPT),
                              max_new=6))
    while eng2.sched.has_work():
        eng2.tick()
    (resumed,) = eng2.finished
    out["prefix"] = np.array(json.dumps({
        "scratch": list(scratch[0].out), "resumed": list(resumed.out),
        "chunks": list(resumed.prefill_chunks),
        "resumed_count": eng2.sched.stats["resumed"],
        "migrations": eng2.kv.stats["migrations"]}))

    # the first prefill chunk's logits, each shard's V/tp columns
    ctx = make_ctx("xla")
    scfg = serve.ServeConfig(**SCFG, attn_impl="ref")
    window = _make_window_forward(cfg, ctx, scfg)

    def first(params, pool, ids, start, n_tok, bt):
        x, _ = window(params, pool[0, 0], ids, start, n_tok, bt)
        return emb.lm_head_logits(params["head"], x[:, -1], ctx)

    ids = np.array([p[:3] for p in PROMPTS], np.int32)
    out["logits"] = np.asarray(jax.jit(smap(
        first, mesh, (api.specs(cfg, ctx), pool_spec, P(), P(), P(), P()),
        P(None, "model")))(
            params, eng.exec.init_pool(), jnp.asarray(ids),
            jnp.zeros((3,), jnp.int32), jnp.full((3,), 3, jnp.int32),
            jnp.asarray(np.array(FIRST_BT, np.int32))))
    out["seconds"] = np.array(time.monotonic() - t_start)
    np.savez(out_path, **out)


# ======================================================================
# the port's side
# ======================================================================
@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_tp") / "ref.npz"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--jax-worker", str(path)], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def port(ref):
    """The port's modules, the smoke config and the reference's weights
    as full port parameters."""
    from repro_torch import configs, serve
    from repro_torch.weights import from_jax

    tree: dict = {}
    for key, leaf in ref.items():
        if key.startswith("param:"):
            *path, name = key[len("param:"):].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[name] = leaf
    return serve, configs.get_smoke("qwen3-8b"), from_jax(tree)


def _ctx(backend, tp=TP):
    from repro_torch.parallel import ParallelCtx
    return ParallelCtx(tp_size=tp, backend=backend)


def _kv(port, scfg):
    from repro_torch.core.heap import SymmetricHeap

    serve, cfg, _ = port
    return serve.PagedKVCache(
        SymmetricHeap(("data", "model")), n_layers=cfg.n_layers,
        kv_heads=cfg.kv_per_rank(TP), head_dim=cfg.head_dim,
        n_pages=scfg.n_pages, page_tokens=scfg.page_tokens)


def _engine(port, backend, *, replicas=DP, my_pe=0, kv=None, scfg=None,
            proposer=None, **kw):
    """A ServeEngine on a StackedExec of ``replicas`` TP4 replicas,
    reading replica ``my_pe``."""
    serve, cfg, params = port
    ctx = _ctx(backend)
    scfg = scfg or serve.ServeConfig(**{"attn_impl": "ref", **SCFG, **kw})
    kv = kv or _kv(port, scfg)
    ex = serve.StackedExec(params, cfg, ctx, scfg, kv, torch.device("cpu"),
                           replicas=replicas, my_pe=my_pe)
    return serve.ServeEngine(params, cfg, scfg, ctx=ctx, exec_=ex,
                             device="cpu", kv=kv, proposer=proposer,
                             my_pe=my_pe)


def _requests(serve, sampling=None, prompts=PROMPTS):
    sp = serve.GREEDY if sampling is None else serve.SamplingParams(**sampling)
    return [serve.Request(rid=i, prompt=list(p), max_new=6, sampling=sp)
            for i, p in enumerate(prompts)]


def _run(port, backend, sampling=None, **kw):
    eng = _engine(port, backend, **kw)
    done = eng.run(_requests(port[0], sampling), clock="tick")
    return {r.rid: list(r.out) for r in done}, eng


def _twin(backend):
    """The reference backend a port backend is held to."""
    return "xla" if backend == "xla" else "posh"


def _want(ref, backend, tag):
    arr = ref[f"streams:{_twin(backend)}:{tag}"]
    return {i: [int(t) for t in row] for i, row in enumerate(arr)}


BACKENDS = ("xla", "posh", "pallas")
TAGS = (("greedy", None), ("sampled", SAMPLED))


def test_reference_worker_within_budget(ref):
    """The JAX worker's own seconds (compiles included) stay well inside
    the tier-1 budget."""
    assert float(ref["seconds"]) < 150, float(ref["seconds"])
    # the reference's backends agree among themselves, as its suite asserts
    for tag, _ in TAGS:
        np.testing.assert_array_equal(ref[f"streams:xla:{tag}"],
                                      ref[f"streams:posh:{tag}"])


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("tag,sampling", TAGS)
def test_dp2_tp4_streams_equal_reference(ref, port, backend, tag, sampling):
    """Check 1: the DP2 x TP4 token streams, greedy and sampled, equal the
    reference's on the twin backend, and the TP step went through the
    communicator: two psums a layer and the embed's, one top-k merge a
    step."""
    got, eng = _run(port, backend, sampling)
    assert got == _want(ref, backend, tag)
    st = eng.ctx.tp_comm.stats()
    n_steps = sum(eng.steps.values())
    assert st["psum"]["calls"] == n_steps * (1 + 2 * port[1].n_layers)
    assert st["top_k_merge"]["calls"] == n_steps
    algos = set(st["psum"]["algos"])
    assert algos == ({"xla"} if backend == "xla" else {"tree"}), algos


def test_batch_invariance(ref, port):
    """Check 2: a sampled request served alone draws the stream it draws
    packed in the full batch."""
    serve = port[0]
    eng = _engine(port, "xla")
    alone = eng.run([serve.Request(rid=1, prompt=list(PROMPTS[1]), max_new=6,
                                   sampling=serve.SamplingParams(**SAMPLED))],
                    clock="tick")
    assert list(alone[0].out) == _want(ref, "xla", "sampled")[1]


@pytest.mark.parametrize("backend", BACKENDS)
def test_tp_argmax_ties_resolve_to_lowest_global_index(backend):
    """Check 3: equal logits in several vocab shards (and inside one)
    resolve to the lowest global index on every backend."""
    from repro_torch.models import embed as emb

    V, vloc = 32, 32 // TP
    logits = np.zeros((2, V), np.float32)
    logits[0, 9] = logits[0, 25] = 3.0
    logits[1, 2] = logits[1, 5] = logits[1, 17] = 7.0
    shards = torch.from_numpy(logits).reshape(2, TP, vloc).transpose(0, 1)
    got = emb.tp_argmax(shards.contiguous(), _ctx(backend))
    assert got.tolist() == [[9, 2]] * TP


def test_replica_page_migration(ref, port, monkeypatch):
    """Check 4: a page moves replica 0 -> replica 1 as one put_nbi per TP
    rank and ONE quiet; the pool equals the reference's bit for bit, and
    nothing else moved."""
    from repro_torch.core import ordering

    serve = port[0]
    eng = _engine(port, "xla")
    shape = tuple(eng.exec.init_pool().shape)
    pool = np.random.RandomState(MIG["seed"]).randn(*shape).astype(np.float32)
    before = pool.copy()
    t = torch.from_numpy(pool)
    counts = []
    orig = ordering.CommQueue.quiet

    def quiet(self):
        counts.append(self.stats()["puts"])
        return orig(self)

    monkeypatch.setattr(ordering.CommQueue, "quiet", quiet)
    out = eng.exec.migrate(t, [serve.PageMigration(
        src_pe=0, dst_pe=1, src_page=MIG["src_page"],
        dst_page=MIG["dst_page"])])
    assert out is t and counts == [TP]              # in place; TP puts, 1 quiet
    np.testing.assert_array_equal(out.numpy(), ref["mig:out"])
    for r in range(TP):
        np.testing.assert_array_equal(out[1, r, MIG["dst_page"]].numpy(),
                                      before[0, r, MIG["src_page"]])


@pytest.mark.parametrize("backend", ("xla", "posh"))
def test_served_pool_equals_reference(ref, port, backend):
    """Every step runs on every replica row, so after the greedy trace the
    stacked (R, TP, ...) pool is the reference's (data, model) pool,
    page 0 aside (padded rows write there)."""
    _, eng = _run(port, backend)
    got, want = eng.pool.numpy()[:, :, 1:], ref[f"pool:{backend}"][:, :, 1:]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


def test_prefix_resume_by_migration(ref, port):
    """Check 5: a second cell on replica 1 resumes from replica 0's
    registered prefix pages (migrated with one quiet), chunk-prefills the
    suffix in >= 2-token chunks and gives the from-scratch stream, as the
    reference's does."""
    serve = port[0]
    want = json.loads(str(ref["prefix"]))
    eng = _engine(port, "xla", prefix_keep=True, my_pe=0)
    done = eng.run([serve.Request(rid=0, prompt=list(PREFIX_PROMPT),
                                  max_new=6)], clock="tick")
    assert list(done[0].out) == want["scratch"]
    assert eng.kv.lookup_prefix(PREFIX_PROMPT) is not None
    eng2 = _engine(port, "xla", my_pe=1, kv=eng.kv, scfg=eng.scfg)
    eng2.pool = eng.pool
    eng2.submit(serve.Request(rid=100, prompt=list(PREFIX_PROMPT), max_new=6))
    while eng2.sched.has_work():
        eng2.tick()
    (resumed,) = eng2.finished
    assert eng2.sched.stats["resumed"] == want["resumed_count"] == 1
    assert eng2.kv.stats["migrations"] == want["migrations"] >= 2
    assert list(resumed.prefill_chunks) == want["chunks"]
    assert max(resumed.prefill_chunks) >= 2
    assert list(resumed.out) == want["resumed"] == want["scratch"]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("tag,sampling", TAGS)
def test_spec_streams_equal_non_spec(ref, port, backend, tag, sampling):
    """Check 6: spec_k=3 with the n-gram proposer gives the reference's
    non-speculative streams through the verify window."""
    got, eng = _run(port, backend, sampling, spec_k=3)
    assert got == _want(ref, backend, tag)
    assert eng.spec_stats["verify_ticks"] > 0 and eng.steps["decode"] == 0


def test_spec_replay_accepts_and_fixed_rewinds(ref, port):
    """Check 6: a replay oracle accepts every draft (> 1 token a pass),
    an adversarial proposer none (pages rewound); streams unchanged."""
    serve = port[0]
    want = _want(ref, "xla", "greedy")
    got, eng = _run(port, "xla", spec_k=3,
                    proposer=serve.ReplayProposer(want))
    sp = eng.metrics()["spec"]
    assert got == want and sp["accept_rate"] == 1.0
    assert sp["tokens_per_tick"] > 1
    got, eng = _run(port, "xla", spec_k=3,
                    proposer=serve.FixedProposer([101, 102, 103]))
    assert got == want and eng.spec_stats["accepted"] == 0
    assert eng.kv.stats["rewound_pages"] > 0


def test_draft_model_proposer_under_a_tp_target(ref, port):
    """A draft model on the target's ctx (its weights stacked once, its
    pool one replica of TP PEs, ``kv_per_rank(tp)`` heads, the shared
    cache's block tables): with the target's own weights it proposes the
    target's tokens, so every draft is accepted and the streams are the
    reference's."""
    serve, cfg, params = port
    ctx = _ctx("posh")
    scfg = serve.ServeConfig(**SCFG, attn_impl="ref", spec_k=3)
    kv = _kv(port, scfg)
    prop = serve.DraftModelProposer(params, cfg, scfg, kv,
                                    target_vocab=cfg.vocab, device="cpu",
                                    ctx=ctx)
    assert tuple(prop.pool.shape[:2]) == (1, TP)
    assert prop.pool.shape[-2] == cfg.kv_per_rank(TP)
    eng = serve.ServeEngine(params, cfg, scfg, ctx=ctx, device="cpu", kv=kv,
                            proposer=prop)
    done = eng.run(_requests(serve), clock="tick")
    assert {r.rid: list(r.out) for r in done} == _want(ref, "posh", "greedy")
    assert eng.metrics()["spec"]["accept_rate"] == 1.0


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("spec_k", (0, 3))
def test_attn_impl_kernel_equals_ref(ref, port, backend, spec_k,
                                     monkeypatch):
    """Check 7 (the plain side): ``attn_impl="kernel"`` serves the same
    streams, greedy and sampled, the verify window included; on the CPU
    the kernel wrappers take their plain versions, with the PE axis
    folded into one call per layer."""
    from repro_torch.kernels import paged_attention as pa

    orig = pa.paged_prefill_attention_ref
    calls = []

    def counted(q, *a):
        calls.append(q.shape[0])
        return orig(q, *a)

    monkeypatch.setattr(pa, "paged_prefill_attention_ref", counted)
    for tag, sampling in TAGS:
        calls.clear()
        got, eng = _run(port, backend, sampling, spec_k=spec_k,
                        attn_impl="kernel")
        assert got == _want(ref, backend, tag)
        n = port[1].n_layers * (eng.steps["prefill"] + eng.steps["verify"])
        assert calls == [TP * DP * SCFG["max_batch"]] * n


def test_shard_for_tp_first_step_logits(ref, port):
    """``shard_for_tp(from_jax(p))``: the first prefill chunk's logits,
    shard by shard, equal the reference's TP4 shards within 1e-5 x max
    |logit|."""
    from repro_torch.serve import engine as se

    serve, cfg, params = port
    ctx = _ctx("xla")
    scfg = serve.ServeConfig(**SCFG, attn_impl="ref")
    ex = serve.StackedExec(params, cfg, ctx, scfg, _kv(port, scfg),
                           torch.device("cpu"), replicas=1)
    window = se._make_window_forward(cfg, scfg, ctx)
    ids = torch.tensor([p[:3] for p in PROMPTS], dtype=torch.int32)
    x, _ = window(ex.params, ex.init_pool(), ids,
                  torch.zeros(3, dtype=torch.int32),
                  torch.full((3,), 3, dtype=torch.int32),
                  torch.tensor(FIRST_BT, dtype=torch.int32))
    from repro_torch.models import embed as emb
    got = emb.lm_head_logits(ex.params["head"], x[:, :, -1], ctx)
    want = ref["logits"].reshape(3, TP, -1).transpose(1, 0, 2)
    assert got.shape == want.shape
    tol = 1e-5 * float(np.abs(want).max())
    for t in range(TP):
        np.testing.assert_allclose(got[t].numpy(), want[t], rtol=0, atol=tol)


def test_shard_for_tp_layout_and_refusals(port):
    """The stacked layout: row splits are views of the full tensors;
    replicated leaves one copy a PE; the replicated KV projections (n_kv
    2 < tp 4) whole on every PE, each rank projecting with its ``my_kv``
    head's columns; stacked parameters come back as given; a MoE block's
    experts split on their own axis; a vocab or a d_ff that does not
    divide raises; the ctx layout (heads not dividing tp), refused
    before, keeps every attention leaf whole on every PE."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models.attention import _kv_weight
    from repro_torch.weights import is_tp_sharded, shard_for_tp

    _, cfg, params = port
    s = shard_for_tp(params, cfg, TP)
    assert is_tp_sharded(s) and not is_tp_sharded(params)
    assert shard_for_tp(s, cfg, TP) is s and shard_for_tp(params, cfg, 1) \
        is params                                   # shared, never re-stacked
    table = params["embed"]["table"]
    assert s["embed"]["table"].data_ptr() == table.data_ptr()
    assert s["blocks"]["attn"]["wo"].data_ptr() == \
        params["blocks"]["attn"]["wo"].data_ptr()
    dh, group, hpr = cfg.head_dim, cfg.n_heads // cfg.n_kv, cfg.n_heads // TP
    wk = params["blocks"]["attn"]["wk"]
    for li in range(cfg.n_layers):
        mine = _kv_weight(s["blocks"]["attn"]["wk"][li], cfg, _ctx("xla"))
        for t in range(TP):
            my_kv = (t * hpr) // group
            assert torch.equal(s["blocks"]["attn"]["wk"][li, t], wk[li])
            assert torch.equal(mine[t], wk[li, :, my_kv * dh:(my_kv + 1) * dh])
    for t in range(TP):
        assert torch.equal(s["ln_f"]["scale"][t], params["ln_f"]["scale"])
        torch.testing.assert_close(
            s["blocks"]["mlp"]["wu"][:, t],
            params["blocks"]["mlp"]["wu"][..., t * cfg.d_ff // TP:
                                          (t + 1) * cfg.d_ff // TP],
            rtol=0, atol=0)
    odd = {**params, "embed": {"table": table[:-1]}}
    with pytest.raises(ValueError, match="vocab"):
        shard_for_tp(odd, cfg, TP)
    moe = configs.get_smoke("qwen3-moe-30b-a3b")     # experts split, no raise
    from repro_torch.models import lm
    mp = lm.init(torch.Generator().manual_seed(0), moe)
    assert shard_for_tp(mp, moe, 2)["blocks"]["mlp"]["wu"].shape[:3] == \
        (moe.n_layers, 2, moe.moe.experts_padded(2) // 2)
    with pytest.raises(ValueError, match="d_ff"):
        shard_for_tp(params, dataclasses.replace(cfg, d_ff=cfg.d_ff + 2), 4)
    ctx6 = shard_for_tp(params, dataclasses.replace(cfg, n_heads=6), 4)
    for name in ("wq", "wk", "wv", "wo"):
        got, w = ctx6["blocks"]["attn"][name], params["blocks"]["attn"][name]
        assert all(torch.equal(got[:, t], w) for t in range(4)), name


def test_tp_ctx_and_engine_refusals(port):
    """A DP x TP ctx builds both communicators (serving ignores
    ``dp_size``: its replicas are ``StackedExec``'s); the ctx layout
    (heads not dividing tp) is refused by the engine, as the reference's
    ``_check_supported`` does; ``my_pe`` must name a replica."""
    import dataclasses

    serve, cfg, params = port
    from repro_torch.parallel import ParallelCtx
    both = ParallelCtx(dp_size=2, tp_size=4, backend="posh")
    assert (both.dp_comm.size, both.tp_comm.size) == (2, 4)
    assert both.dp_comm.backend_name == both.tp_comm.backend_name == "posh"
    assert both.dp_rank("cpu").tolist() == [0, 1]
    ctx = ParallelCtx(tp_size=4)
    assert ctx.tp_comm.size == 4 and ctx.tp_rank("cpu").tolist() == [0, 1, 2, 3]
    with pytest.raises(NotImplementedError, match="head-parallel"):
        serve.ServeEngine(params, dataclasses.replace(cfg, n_heads=6),
                          serve.ServeConfig(**SCFG), ctx=ctx, device="cpu")
    with pytest.raises(ValueError, match="replicas"):
        scfg = serve.ServeConfig(**SCFG)
        serve.StackedExec(params, cfg, ctx, scfg, _kv(port, scfg),
                          torch.device("cpu"), replicas=2, my_pe=2)


def test_stacked_block_tables_give_each_pe_its_pages(port):
    """The kernels' rows: PE (replica r, rank t) reads page ``p`` of its
    own pool as ``p + (r * TP + t) * n_pages`` of the merged page axis,
    its page 0 its own null page."""
    from repro_torch.serve import engine as se

    pool = torch.zeros((DP, TP, 24, 1))
    bt = torch.tensor([[1, 0], [2, 3], [0, 0], [4, 5]], dtype=torch.int32)
    got = se._pe_pages(bt, pool, _ctx("xla"))
    assert got.shape == (TP, 4, 2) and got.dtype == torch.int32
    for t in range(TP):
        for n in range(4):
            r = n // 2
            assert got[t, n].tolist() == (bt[n] + (r * TP + t) * 24).tolist()
    assert se._pages_view(torch.zeros(DP, TP, 24, 2, 3), _ctx("xla")).shape \
        == (DP * TP * 24, 2, 3)


if __name__ == "__main__" and "--jax-worker" in sys.argv:
    _jax_worker(sys.argv[sys.argv.index("--jax-worker") + 1])
