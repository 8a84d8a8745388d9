"""Disaggregated prefill/decode cells of tensor-parallel size 2
(``DisaggEngine(ctx=ParallelCtx(tp_size=2))``, one TP group a cell) against
the JAX reference's 4-cell x TP2 mesh serving.

The reference runs its cells on a (cells 4, model 2) mesh of 8 CPU
devices, set before JAX starts; so this file re-executes itself in a
subprocess (``--jax-worker``) with
``XLA_FLAGS=--xla_force_host_platform_device_count=8``.  The worker
rebuilds the reference's cell wiring here (``CellMeshExec`` of the
multi-PE disagg suite: one set of shard_map'd step functions per
backend shared by every cell, each cell reading its own replica row),
and serves the suite's four prompts (arrivals ``i // 2``) on the smoke
qwen3-8b in f32 colocated under ``xla`` and ``posh``, greedy and
sampled, then 2P + 2D cells under xla with the host router, spec_k 0
and 3, whose ``stats()`` it keeps.

The port serves the same ``from_jax`` weights: its 2+2 TP2 cells —
every backend (pallas held to the reference's posh), greedy and
sampled, spec_k 0 and 3, router host and amo — must give the
reference's colocated streams, drain every handoff with one
``signal_wait_until`` per ticket and no quiet (signals == pages, waits
== tickets), share ONE stacked weights dict, and land each page's TP
shards intact; ``stats()`` equal the reference's cells'.  A TP2 hot
swap's post-flip streams equal a cold TP2 engine's on the new weights,
colocated and across the cells.  Nothing here has a tolerance.
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
N_CELLS, TP = 4, 2
PROMPTS = [list(range(3, 11)), list(range(40, 46)), [7, 3, 99, 12, 55],
           [5, 17, 42] * 3]
SCFG = dict(page_tokens=4, n_pages=24, max_batch=3, max_seq=32,
            prefill_chunk=3)
SAMPLED = dict(temperature=0.8, top_k=5, top_p=0.9)
STATS = ("handoff_tickets", "handoff_pages", "handoff_deferred",
         "handoff_signals", "handoff_waits", "handoff_quiets")


# ======================================================================
# the JAX worker (a subprocess with 8 CPU devices)
# ======================================================================
def _jax_worker(out_path: str) -> None:
    t_start = time.monotonic()
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro import compat, configs, serve
    from repro.core import SymmetricHeap
    from repro.models import registry
    from repro.parallel.ctx import ParallelCtx, smap

    mesh = compat.make_mesh((N_CELLS, TP), ("data", "model"))
    pool_spec = P("data", "model")
    cfg = configs.get_smoke("qwen3-8b")
    api = registry.build(cfg)
    f32 = dict(param_dtype=jnp.float32, compute_dtype=jnp.float32)
    params = api.init(jax.random.PRNGKey(0), cfg,
                      ParallelCtx(dp_size=1, tp_size=1, sp=False,
                                  remat=False, **f32))

    def make_ctx(backend):
        return ParallelCtx(dp_size=N_CELLS, tp_size=TP, sp=False,
                           remat=False, backend=backend, **f32)

    steps = {}

    def jitted(backend, scfg):
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

    class CellMeshExec:
        def __init__(self, backend, scfg, kv, my_pe):
            self.params, self.kv, self.my_pe = params, kv, my_pe
            self._prefill, self._decode, self._verify = jitted(backend,
                                                               scfg)

        def _my_row(self, toks):
            t = np.asarray(toks)
            return t.reshape((N_CELLS, -1) + t.shape[1:])[self.my_pe]

        def init_pool(self):
            return jnp.zeros((N_CELLS, TP) + self.kv.handle.shape,
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

        def read_pages(self, pool, pages):
            mine = np.asarray(pool)[self.my_pe]
            return np.swapaxes(mine[:, np.asarray(pages, np.int64)], 0, 1)

        def write_pages(self, pool, pages, rows):
            idx = jnp.asarray(np.asarray(pages, np.int64))
            return pool.at[self.my_pe, :, idx].set(jnp.asarray(rows))

    def cell_engine(backend, scfg, role, my_pe):
        kv = serve.PagedKVCache(
            SymmetricHeap(("data", "model"), capacity_bytes=1 << 30),
            n_layers=cfg.n_layers, kv_heads=cfg.kv_per_rank(TP),
            head_dim=cfg.head_dim, n_pages=scfg.n_pages,
            page_tokens=scfg.page_tokens)
        return serve.ServeEngine(params, cfg, make_ctx(backend), scfg,
                                 kv=kv,
                                 exec_=CellMeshExec(backend, scfg, kv, my_pe),
                                 my_pe=my_pe, role=role)

    def reqs(sampling):
        return [serve.Request(rid=i, prompt=list(p), max_new=6,
                              sampling=sampling, t_arrive=i // 2)
                for i, p in enumerate(PROMPTS)]

    out = {f"param:{'/'.join(str(k.key) for k in path)}": np.asarray(leaf)
           for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    sampled = serve.SamplingParams(**SAMPLED)
    for backend in ("xla", "posh"):
        scfg = serve.ServeConfig(**SCFG, attn_impl="ref")
        for tag, sp in (("greedy", serve.GREEDY), ("sampled", sampled)):
            done = cell_engine(backend, scfg, "both", 0).run(reqs(sp),
                                                             clock="tick")
            out[f"streams:{backend}:{tag}"] = np.array(
                [list(r.out) for r in sorted(done, key=lambda r: r.rid)],
                np.int32)
    for spec_k in (0, 3):
        scfg = serve.ServeConfig(**SCFG, attn_impl="ref", spec_k=spec_k)
        cells = serve.make_cells(2, 2, pes_per_cell=TP)
        eng = serve.DisaggEngine(
            params, cfg, make_ctx("xla"), scfg, n_prefill=2, n_decode=2,
            pes_per_cell=TP, router="host",
            engines=[cell_engine("xla", scfg, c.role, c.cell)
                     for c in cells])
        done = eng.run(reqs(serve.GREEDY), clock="tick")
        hs = eng.stats()
        out[f"disagg:{spec_k}"] = np.array(json.dumps({
            "streams": {r.rid: list(r.out) for r in done},
            "stats": {k: int(hs[k]) for k in STATS}}))
    out["seconds"] = np.array(time.monotonic() - t_start)
    np.savez(out_path, **out)


# ======================================================================
# the port's side
# ======================================================================
@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_tp_disagg") / "ref.npz"
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


def _ctx(backend):
    from repro_torch.parallel import ParallelCtx
    return ParallelCtx(tp_size=TP, backend=backend)


def _scfg(serve, **kw):
    return serve.ServeConfig(**{"attn_impl": "ref", **SCFG, **kw})


def _reqs(serve, sampling=None, prompts=PROMPTS, base=0):
    sp = serve.GREEDY if sampling is None else serve.SamplingParams(**sampling)
    return [serve.Request(rid=base + i, prompt=list(p), max_new=6,
                          sampling=sp, t_arrive=i // 2)
            for i, p in enumerate(prompts)]


def _streams(done, keep=lambda rid: True):
    return {r.rid: list(r.out) for r in done if keep(r.rid)}


def _want(ref, backend, tag):
    arr = ref[f"streams:{'xla' if backend == 'xla' else 'posh'}:{tag}"]
    return {i: [int(t) for t in row] for i, row in enumerate(arr)}


def _disagg(port, backend, params=None, **kw):
    serve, cfg, full = port
    router = kw.pop("router", "host")
    return serve.DisaggEngine(full if params is None else params, cfg,
                              _scfg(serve, **kw), ctx=_ctx(backend),
                              device="cpu", n_prefill=2, n_decode=2,
                              router=router)


BACKENDS = ("xla", "posh", "pallas")
TAGS = (("greedy", None), ("sampled", SAMPLED))


def test_reference_worker_within_budget(ref):
    assert float(ref["seconds"]) < 150, float(ref["seconds"])


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("tag,sampling", TAGS)
def test_tp2_colocated_streams_equal_reference(ref, port, backend, tag,
                                               sampling):
    """A colocated TP2 engine (one replica on the stacked team) gives the
    reference cell's streams."""
    serve, cfg, params = port
    eng = serve.ServeEngine(params, cfg, _scfg(serve), ctx=_ctx(backend),
                            device="cpu")
    assert isinstance(eng.exec, serve.StackedExec) and eng.exec.tp == TP
    assert tuple(eng.pool.shape[:2]) == (1, TP)
    done = eng.run(_reqs(serve, sampling), clock="tick")
    assert _streams(done) == _want(ref, backend, tag)


@pytest.mark.parametrize("router", ("host", "amo"))
@pytest.mark.parametrize("spec_k", (0, 3))
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("tag,sampling", TAGS)
def test_tp2_disagg_streams_equal_colocated(ref, port, backend, tag,
                                            sampling, spec_k, router):
    """Check 1-2: 2P + 2D cells x TP2 give the colocated streams on every
    backend, greedy and sampled, spec_k 0 and 3, router host and amo;
    the handoff drains by signals alone (one wait per ticket, one signal
    per page, no quiet) and the cells share one stacked weights dict."""
    serve = port[0]
    eng = _disagg(port, backend, spec_k=spec_k, router=router)
    done = eng.run(_reqs(serve, sampling), clock="tick")
    assert _streams(done) == _want(ref, backend, tag)
    hs = eng.stats()
    assert hs["handoff_quiets"] == 0 and hs["router_quiets"] == 0, hs
    assert hs["handoff_signals"] == hs["handoff_pages"] > 0, hs
    assert hs["handoff_waits"] == hs["handoff_tickets"] == len(PROMPTS), hs
    assert eng.hq.pending_ops() == 0
    p0 = eng.engines[0].exec.params
    assert all(e.exec.params is p0 for e in eng.engines)
    assert all(tuple(e.pool.shape[:2]) == (1, TP) for e in eng.engines)
    if router == "amo":
        assert hs["router_amos"] > 0 and hs["handoff_amos"] > 0, hs
        for p in eng.pools:
            ps = p.queue_stats()
            assert ps["quiets"] == ps["fences"] == 0
    if spec_k:
        assert sum(eng.engines[c].spec_stats["verify_ticks"]
                   for c in eng.router.decode) > 0


@pytest.mark.parametrize("spec_k", (0, 3))
def test_tp2_disagg_stats_equal_reference(ref, port, spec_k):
    """The host-router 2+2 TP2 run's streams and handoff counters equal
    the reference cells'."""
    want = json.loads(str(ref[f"disagg:{spec_k}"]))
    eng = _disagg(port, "xla", spec_k=spec_k)
    done = eng.run(_reqs(port[0]), clock="tick")
    assert {str(k): v for k, v in _streams(done).items()} == want["streams"]
    hs = eng.stats()
    assert {k: hs[k] for k in STATS} == want["stats"]


def test_tp2_shards_land_intact(port):
    """Check 3: replica-distinct contents on the producer cell land in the
    consumer cell's pool shard for shard, per TP rank."""
    serve = port[0]
    eng = _disagg(port, "xla")
    prod = eng.engines[0]
    rng = np.random.RandomState(7)
    pool = torch.from_numpy(rng.randn(*prod.pool.shape).astype(np.float32))
    prod.pool = pool.clone()
    assert prod.kv.alloc_seq(123, 7)              # 2 pages on the producer
    req = serve.Request(rid=123, prompt=[1, 2, 3, 4, 5, 6, 7], max_new=4)
    req.n_done = req.n_prompt
    req.out.append(9)
    prod.handoff_ready.append(req)
    src_pages = list(prod.kv.tables[123])
    eng._issue_handoffs(0)
    (ticket,) = eng._inbox[eng.router.decode[0]]
    dst_cell, dst_pages = ticket.dst_cell, list(ticket.dst_pages)
    eng._drain_inbox(dst_cell, now=0.0)
    got = eng.engines[dst_cell].pool
    for sp, dp in zip(src_pages, dst_pages):
        for t in range(TP):
            torch.testing.assert_close(got[0, t, dp], pool[0, t, sp],
                                       rtol=0, atol=0)
    assert eng.stats()["handoff_quiets"] == 0
    assert tuple(eng._mail_state["kv_mail"].shape[2:4]) == (TP, 2)


def _new_params(port, seed=7):
    from repro_torch.models import lm
    return lm.init(torch.Generator().manual_seed(seed), port[1])


def test_tp2_hot_swap_colocated_equals_cold_engine(port):
    """A TP2 engine streams a new generation over its 2 PEs while serving;
    after the flip its streams equal a cold TP2 engine's on the new
    weights, with no extra global drain."""
    serve, cfg, params = port
    new = _new_params(port)
    eng = serve.ServeEngine(params, cfg, _scfg(serve), ctx=_ctx("posh"),
                            device="cpu")
    eng.begin_hot_swap(new, chunk_rows=2)
    assert eng._swap.n_pe == TP
    eng.run(_reqs(serve), clock="tick")
    assert not eng.swap_in_flight()
    assert eng.swap_stats["flips"] == 1
    assert eng.swap_stats["swap_extra_quiets"] == 0
    eng.run(_reqs(serve, SAMPLED, base=10), clock="tick")
    cold = serve.ServeEngine(new, cfg, _scfg(serve), ctx=_ctx("posh"),
                             device="cpu")
    keep = lambda rid: rid >= 10                    # noqa: E731
    assert _streams(eng.finished, keep) == _streams(
        cold.run(_reqs(serve, SAMPLED, base=10), clock="tick"))


def test_tp2_hot_swap_disagg_flips_every_cell_with_one_dict(port):
    """Across 2+2 TP2 cells the flip stacks the new generation once and
    hands every cell that one dict on one tick; post-flip streams equal a
    cold TP2 engine's."""
    serve, cfg, params = port
    new = _new_params(port, seed=11)
    eng = _disagg(port, "xla")
    seen = []
    for i, e in enumerate(eng.engines):
        orig = e.exec.set_params

        def record(p, i=i, orig=orig):
            seen.append((eng.ticks, i, id(p)))
            return orig(p)

        e.exec.set_params = record
    eng.begin_hot_swap(new, chunk_rows=2)
    eng.run(_reqs(serve), clock="tick")
    assert len(seen) == 4 and len({t for t, _, _ in seen}) == 1
    assert len({p for _, _, p in seen}) == 1
    assert all(e.exec.params is eng.engines[0].exec.params
               for e in eng.engines)
    assert eng.swap_stats["flips"] == 1
    assert eng.stats()["handoff_quiets"] == 0
    eng.run(_reqs(serve, base=10), clock="tick")
    cold = serve.ServeEngine(new, cfg, _scfg(serve), ctx=_ctx("xla"),
                             device="cpu")
    assert _streams(eng.finished, lambda rid: rid >= 10) == _streams(
        cold.run(_reqs(serve, base=10), clock="tick"))


def test_tp_cell_refusals(port):
    """Cells of a TP size that does not divide the query heads raise
    (the head-parallel layout); a MoE config's cells build at TP, its
    experts stacked once for every cell."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.parallel import ParallelCtx

    serve, cfg, params = port
    with pytest.raises(NotImplementedError, match="head-parallel"):
        serve.DisaggEngine(params, cfg, _scfg(serve), device="cpu",
                           ctx=ParallelCtx(tp_size=3, backend="xla"))
    moe = configs.get_smoke("qwen3-moe-30b-a3b")
    d = serve.DisaggEngine(lm.init(torch.Generator().manual_seed(0), moe),
                           moe, _scfg(serve), ctx=_ctx("xla"), device="cpu")
    wu = {id(e.exec.params["blocks"]["mlp"]["wu"]) for e in d.engines}
    assert len(wu) == 1 and d.engines[0].exec.params["blocks"]["mlp"][
        "wu"].shape[1] == TP


def test_cli_builder_accepts_a_tp_ctx(port):
    """``launch.serve.build_engine`` serves at TP with a ctx: colocated
    (a StackedExec) and disaggregated (one TP group a cell)."""
    from repro_torch.launch import serve as launch

    kw = dict(config="smoke", dtype="f32", device="cpu", page_tokens=4,
              n_pages=16, max_batch=2, prefill_chunk=4, ctx=_ctx("posh"))
    eng, cfg = launch.build_engine(**kw)
    assert eng.exec.tp == TP and eng.kv.kv_heads == cfg.kv_per_rank(TP)
    done = eng.run(_reqs(port[0], prompts=PROMPTS[:2]), clock="tick")
    dis, _ = launch.build_engine(disagg="1+1", **kw)
    assert _streams(dis.run(_reqs(port[0], prompts=PROMPTS[:2]),
                            clock="tick")) == _streams(done)


if __name__ == "__main__" and "--jax-worker" in sys.argv:
    _jax_worker(sys.argv[sys.argv.index("--jax-worker") + 1])
