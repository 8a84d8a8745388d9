"""repro_torch.ckpt.hotswap: the zero-downtime weight hot-swap, against
the JAX package — the five hot-swap cases of ``tests/test_slo.py`` on
the smoke qwen3-8b in f32, the weights carried across by
``weights.from_jax``:

  * the flip is cold-start bit-identical (greedy and sampled), and the
    pre-flip trace ran on the old weights;
  * the stream overlaps serving ticks (one 4 KiB row a tick), a second
    start is refused, a second generation follows;
  * it composes with speculation (k = 2) and with 1+1 disaggregated
    cells;
  * a metrics reset keeps the generation.

In each the port's streams equal the JAX engine's and ``swap_stats``
equals the reference's key for key, ``swap_extra_quiets == 0``.  Then
the pieces: ``_pack`` gives the reference's bytes, ``_unpack`` inverts
it in f32, bf16 and int32 and returns views of the stage, a batch's put
carries PE 0's rows alone, ``--hot-swap`` through the CLI, and a 2+2
topology flipping every cell on one tick.  The JAX runs are cached per
module.  Nothing here has a tolerance.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import serve as jserve
from repro.ckpt import hotswap as jhotswap
from repro.models import registry
from repro.parallel.ctx import ParallelCtx
from repro_torch import configs, serve
from repro_torch.ckpt import hotswap
from repro_torch.launch import serve as launch
from repro_torch.train import tree
from repro_torch.weights import from_jax

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def models():
    """``gen(seed)`` -> (JAX params, the port's params), both from
    ``PRNGKey(seed)``; seed 0 is the served generation."""
    jcfg = jconfigs.get_smoke("qwen3-8b")
    ctx = ParallelCtx(dp_size=1, tp_size=1, sp=False, remat=False,
                      param_dtype=jnp.float32, compute_dtype=jnp.float32)

    @functools.lru_cache(maxsize=None)
    def gen(seed):
        jp = registry.build(jcfg).init(jax.random.PRNGKey(seed), jcfg, ctx)
        return jp, from_jax(jax.tree.map(np.asarray, jp))

    return jcfg, ctx, configs.get_smoke("qwen3-8b"), gen


def _params(models, mod, seed):
    """The generation drawn from ``PRNGKey(seed)``, in ``mod``'s package."""
    jp, params = models[3](seed)
    return params if mod is serve else jp


def _reqs(mod, rids, vocab, sampled=True):
    sp = mod.SamplingParams(temperature=0.8, top_k=5, top_p=0.9)
    return [mod.Request(
        rid=rid, prompt=[(7 * rid + k) % vocab for k in range(5)], max_new=6,
        sampling=sp if (sampled and j % 2) else mod.GREEDY)
        for j, rid in enumerate(rids)]


def _spec_reqs(mod, rids):
    return [mod.Request(rid=i, prompt=[5, 17, 42] * 3, max_new=8)
            for i in rids]


def _streams(done, keep=lambda rid: True):
    return {r.rid: list(r.out) for r in done if keep(r.rid)}


def _scfg(mod, **kw):
    if mod is jserve:
        kw["attn_impl"] = "ref"
    return mod.ServeConfig(**kw)


def _engine(mod, models, params, scfg):
    jcfg, ctx, cfg, _ = models
    if mod is jserve:
        return jserve.ServeEngine(params, jcfg, ctx, scfg)
    return serve.ServeEngine(params, cfg, scfg, device="cpu")


def _disagg(mod, models, params, scfg, p, d):
    jcfg, ctx, cfg, _ = models
    if mod is jserve:
        return jserve.DisaggEngine(params, jcfg, ctx, scfg, n_prefill=p,
                                   n_decode=d)
    return serve.DisaggEngine(params, cfg, scfg, device="cpu", n_prefill=p,
                              n_decode=d)


# ----------------------------------------------------------------------
# the five engine cases, each run in both packages
# ----------------------------------------------------------------------
def _cold_start_case(mod, models):
    """test_slo's flip case: stream generation 2 in during a live trace,
    then serve a second trace on the same engine."""
    params, new = (_params(models, mod, s) for s in (0, 7))
    vocab = models[0].vocab
    scfg = _scfg(mod, page_tokens=4, n_pages=32, max_batch=3, max_seq=32)
    eng = _engine(mod, models, params, scfg)
    eng.begin_hot_swap(new, chunk_rows=2)
    eng.run(_reqs(mod, range(3), vocab), clock="tick")
    assert not eng.swap_in_flight()
    stats = dict(eng.swap_stats)
    eng.run(_reqs(mod, range(10, 13), vocab), clock="tick")
    return {"pre": _streams(eng.finished, lambda rid: rid < 3),
            "post": _streams(eng.finished, lambda rid: rid >= 10),
            "stats": stats, "metrics_swap": eng.metrics()["swap"]}


def _overlap_case(mod, models):
    """test_slo's overlap case: one 4 KiB row a tick, so the flip lands
    strictly after the first serving tick; a second start is refused; a
    second generation follows the first."""
    params, new = (_params(models, mod, s) for s in (0, 8))
    scfg = _scfg(mod, page_tokens=4, n_pages=32, max_batch=2, max_seq=32)
    eng = _engine(mod, models, params, scfg)
    eng.begin_hot_swap(new, chunk_rows=1, row_bytes=1 << 12)
    with pytest.raises(RuntimeError):
        eng.begin_hot_swap(new)
    eng.submit(mod.Request(rid=0, prompt=[5, 17, 42], max_new=4))
    eng.tick()
    in_flight = eng.swap_in_flight()
    while eng.sched.has_work() or eng.swap_in_flight():
        eng.tick()
    first = dict(eng.swap_stats)
    eng.begin_hot_swap(params, chunk_rows=64)
    while eng.swap_in_flight():
        eng.tick()
    return {"in_flight_after_t1": in_flight, "first": first,
            "second": dict(eng.swap_stats), "ticks": eng.ticks,
            "streams": _streams(eng.finished)}


def _spec_case(mod, models):
    params, new = (_params(models, mod, s) for s in (0, 9))
    scfg = _scfg(mod, page_tokens=4, n_pages=48, max_batch=3, max_seq=48,
                 spec_k=2)
    eng = _engine(mod, models, params, scfg)
    eng.begin_hot_swap(new, chunk_rows=4)
    eng.run(_spec_reqs(mod, (0, 1)), clock="tick")
    stats = dict(eng.swap_stats)
    eng.run(_spec_reqs(mod, (5,)), clock="tick")
    return {"pre": _streams(eng.finished, lambda rid: rid < 5),
            "post": _streams(eng.finished, lambda rid: rid == 5),
            "stats": stats, "spec": eng.metrics()["spec"]}


def _disagg_case(mod, models):
    params, new = (_params(models, mod, s) for s in (0, 11))
    vocab = models[0].vocab
    scfg = _scfg(mod, page_tokens=4, n_pages=24, max_batch=3, max_seq=32,
                 prefill_chunk=4)
    dis = _disagg(mod, models, params, scfg, 1, 1)
    dis.begin_hot_swap(new, chunk_rows=2)
    dis.run(_reqs(mod, range(3), vocab, sampled=False), clock="tick")
    stats, handoff = dict(dis.swap_stats), dis.stats()
    dis.run(_reqs(mod, range(10, 12), vocab, sampled=False), clock="tick")
    return {"pre": _streams(dis.finished, lambda rid: rid < 3),
            "post": _streams(dis.finished, lambda rid: rid >= 10),
            "stats": stats, "handoff": handoff,
            "metrics_swap": dis.metrics()["swap"]}


def _reset_case(mod, models):
    params = _params(models, mod, 0)
    scfg = _scfg(mod, page_tokens=4, n_pages=16, max_batch=2, max_seq=32)
    eng = _engine(mod, models, params, scfg)
    eng.begin_hot_swap(params, chunk_rows=64)
    while eng.swap_in_flight():
        eng.tick()
    before = dict(eng.swap_stats)
    eng.reset_metrics()
    return {"before": before, "after": dict(eng.swap_stats),
            "attained": eng.metrics()["slo"]["attained"]["interactive"]}


CASES = {"cold_start": _cold_start_case, "overlap": _overlap_case,
         "spec": _spec_case, "disagg": _disagg_case, "reset": _reset_case}


@pytest.fixture(scope="module")
def jax_case(models):
    @functools.lru_cache(maxsize=None)
    def run(name):
        return CASES[name](jserve, models)

    return run


def test_hot_swap_flip_is_cold_start_bit_identical(models, jax_case):
    """The flip is cold-start identical: the second trace's streams
    (greedy and sampled) equal a cold engine's on the new weights, the
    first trace ran on the old weights, and the swap paid no global
    drain — all as in the JAX engine."""
    got, want = _cold_start_case(serve, models), jax_case("cold_start")
    assert got == want
    assert got["stats"]["flips"] == 1 and got["stats"]["generation"] == 1
    assert got["stats"]["swap_extra_quiets"] == 0
    assert got["stats"]["swap_bytes"] > 0
    params, new = models[3](0)[1], models[3](7)[1]
    scfg = _scfg(serve, page_tokens=4, n_pages=32, max_batch=3, max_seq=32)
    vocab = models[0].vocab
    cold = _engine(serve, models, new, scfg)
    assert got["post"] == _streams(cold.run(_reqs(serve, range(10, 13), vocab),
                                            clock="tick"))
    old = _engine(serve, models, params, scfg)
    assert got["pre"] == _streams(old.run(_reqs(serve, range(3), vocab),
                                          clock="tick"))


def test_hot_swap_overlaps_serving_ticks(models, jax_case):
    got, want = _overlap_case(serve, models), jax_case("overlap")
    assert got == want
    assert got["in_flight_after_t1"]          # still streaming after t1
    assert got["first"]["flips"] == 1
    assert got["first"]["swap_ticks"] > 2     # spread over many ticks
    assert got["second"]["generation"] == 2
    assert got["second"]["swap_extra_quiets"] == 0


def test_hot_swap_composes_with_spec(models, jax_case):
    """Flip mid-run with speculation on: the post-flip spec stream equals
    a cold spec engine's on the new weights, and the reference's."""
    got, want = _spec_case(serve, models), jax_case("spec")
    assert got == want
    assert got["stats"]["flips"] == 1
    new = models[3](9)[1]
    scfg = _scfg(serve, page_tokens=4, n_pages=48, max_batch=3, max_seq=48,
                 spec_k=2)
    cold = _engine(serve, models, new, scfg)
    assert got["post"] == _streams(cold.run(_spec_reqs(serve, (5,)),
                                            clock="tick"))
    assert cold.spec_stats["drafted"] > 0


def test_hot_swap_composes_with_disagg(models, jax_case):
    """One streamer spans the 1+1 cell space: both cells flip on one
    topology tick, the handoff and swap queues stay barrier-free, and
    the post-flip streams equal a cold colocated engine's."""
    got, want = _disagg_case(serve, models), jax_case("disagg")
    assert got == want
    assert got["stats"]["flips"] == 1
    assert got["stats"]["swap_extra_quiets"] == 0
    assert got["handoff"]["handoff_quiets"] == 0
    scfg = _scfg(serve, page_tokens=4, n_pages=24, max_batch=3, max_seq=32,
                 prefill_chunk=4)
    cold = _engine(serve, models, models[3](11)[1], scfg)
    vocab = models[0].vocab
    assert got["post"] == _streams(cold.run(
        _reqs(serve, range(10, 12), vocab, sampled=False), clock="tick"))


def test_swap_metrics_reset_keeps_generation(models, jax_case):
    got, want = _reset_case(serve, models), jax_case("reset")
    assert got == want
    assert got["after"]["flips"] == 0
    assert got["after"]["generation"] == 1     # monotone across resets
    assert got["attained"] == 1.0


# ----------------------------------------------------------------------
# the pieces
# ----------------------------------------------------------------------
def test_pack_gives_the_reference_bytes(models):
    """``_pack`` of the carried-across params: the reference's payload
    byte for byte, the same leaf shapes in the same order."""
    jp, params = models[3](0)
    want, jspecs, _ = jhotswap._pack(jp)
    got, specs, _ = hotswap._pack(params)
    assert bytes(got.numpy()) == want
    assert [s for s, _ in specs] == [tuple(s) for s, _ in jspecs]
    rows, _, _ = hotswap._pack(params, row_bytes=1 << 12)
    assert rows.numel() % (1 << 12) == 0
    assert bytes(rows[:len(want)].numpy()) == want
    assert not rows[len(want):].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_unpack_inverts_pack(dtype):
    g = torch.Generator().manual_seed(3)
    params = {"b": {"w": (torch.randn(3, 5, generator=g) * 100).to(dtype),
                    "s": torch.arange(7).to(dtype)},
              "a": [(torch.randn(2, 2, generator=g) * 100).to(dtype)],
              "z": torch.tensor(-3).to(dtype)}
    payload, specs, treedef = hotswap._pack(params)
    out = hotswap._unpack(payload, specs, treedef)
    assert tree.describe(out) == tree.describe(params)
    for a, b in zip(tree.leaves(params), tree.leaves(out)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # bytes in, the same tree out; a misaligned leaf is copied, not viewed
    again = hotswap._unpack(bytes(payload.numpy()), specs, treedef)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(params),
                                                 tree.leaves(again)))
    odd = torch.cat([torch.zeros(1, dtype=torch.uint8), payload])
    shifted = hotswap._unpack(odd[1:], specs, treedef)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(params),
                                                 tree.leaves(shifted)))


def test_result_views_the_stage_and_puts_carry_one_pe(models):
    """After the flip ``result()`` is views of PE 0's staged bytes (no
    copy), every PE staged the same bytes, and each batch's put carried
    PE 0's rows alone, ``(1, chunk_rows, row_bytes)``, landing in every
    PE's stage."""
    params = models[3](0)[1]
    st = hotswap.WeightStreamer(params, n_pe=3, chunk_rows=8,
                                row_bytes=1 << 12, device="cpu")
    sizes = []
    put = st.q.put_signal_nbi

    def spy(handle, data, *a, **k):
        sizes.append(tuple(data.shape))
        return put(handle, data, *a, **k)

    st.q.put_signal_nbi = spy
    while not st.step():
        pass
    out = st.result()
    stage = st.q.state[st.handle.name]
    assert isinstance(stage, list) and len(stage) == 3
    base = stage[0].data_ptr()
    end = base + stage[0].numel()
    for a, b in zip(tree.leaves(params), tree.leaves(out)):
        assert torch.equal(a, b)
        assert base <= b.data_ptr() < end          # a view of the stage
    assert set(sizes[:-1]) == {(1, 8, 1 << 12)}
    assert st.stats["batches"] == len(sizes)
    assert st.extra_global_drains() == 0
    assert st.q.stats()["quiets"] == st.q.stats()["fences"] == 0
    with pytest.raises(RuntimeError):
        hotswap.WeightStreamer(params, device="cpu").result()


def test_cli_hot_swap_flips_once(capsys):
    launch.main(["--config", "smoke", "--device", "cpu", "--dtype", "f32",
                 "--requests", "3", "--page-tokens", "4", "--n-pages", "32",
                 "--max-batch", "2", "--prefill-chunk", "4", "--hot-swap"])
    out = capsys.readouterr().out
    assert "hot_swap=True" in out
    m = json.loads(out[out.index("{"):])
    assert m["swap"]["flips"] == 1 and m["swap"]["generation"] == 1
    assert m["swap"]["swap_extra_quiets"] == 0
    assert m["swap"]["swap_bytes"] > 0
    assert m["requests"] == 3


def test_disagg_2p2_flips_every_cell_on_one_tick(models):
    """2+2 cells: every cell's ``set_params`` gets the same reassembled
    dict on the same topology tick, before any cell steps; the old
    weights are held by no cell after it."""
    params, new = models[3](0)[1], models[3](11)[1]
    cfg = models[2]
    scfg = serve.ServeConfig(page_tokens=4, n_pages=24, max_batch=3,
                             max_seq=32, prefill_chunk=4)
    dis = serve.DisaggEngine(params, cfg, scfg, device="cpu", n_prefill=2,
                             n_decode=2)
    seen = []
    for i, e in enumerate(dis.engines):
        orig = e.exec.set_params

        def record(p, i=i, orig=orig):
            seen.append((dis.ticks, i, id(p)))
            return orig(p)

        e.exec.set_params = record
    dis.begin_hot_swap(new, chunk_rows=2)
    dis.run(_reqs(serve, range(4), cfg.vocab, sampled=False), clock="tick")
    assert len(seen) == 4
    assert len({t for t, _, _ in seen}) == 1
    assert sorted(i for _, i, _ in seen) == [0, 1, 2, 3]
    assert len({p for _, _, p in seen}) == 1
    assert all(e.exec.params is dis.engines[0].exec.params
               for e in dis.engines)
    assert dis.engines[0].exec.params is not params
    assert dis.swap_stats["flips"] == 1
    assert dis.swap_stats["swap_extra_quiets"] == 0
    assert dis.stats()["handoff_quiets"] == 0
    dis.run(_reqs(serve, range(10, 12), cfg.vocab, sampled=False),
            clock="tick")
    cold = serve.ServeEngine(new, cfg, scfg, device="cpu")
    assert _streams(dis.finished, lambda rid: rid >= 10) == _streams(
        cold.run(_reqs(serve, range(10, 12), cfg.vocab, sampled=False),
                 clock="tick"))
