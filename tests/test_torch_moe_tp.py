"""MoE serving at tensor-parallel size > 1 (``ParallelCtx(tp_size=T,
moe_dispatch=...)``, ``serve.StackedExec``) against the JAX reference's
MoE layer and its 8-PE mesh serving, on the smoke configs of both MoE
archs (qwen3-moe-30b-a3b: 8 experts top-2; qwen2-moe-a2.7b: 6 experts
padded to 8, top-2, a shared expert).

The reference runs on meshes of 8 CPU devices, which must be set before
JAX starts; so this file re-executes itself in a subprocess
(``--jax-worker``) with ``XLA_FLAGS=--xla_force_host_platform_device_count=8``,
as ``test_torch_tp.py`` does.  The worker runs:

  * the reference's ``moe_apply`` (layer 0's weights, seeded inputs whose
    rows end in copies of one token) under ``smap`` on a (1, tp) mesh at
    tp 2 and 4, ``moe_dispatch`` einsum and alltoall, backends xla and
    posh, at the smoke capacity factor (8.0: nothing drops), and at tp 4
    also at 1.0 (pairs drop), each PE's output stacked;
  * the reference's ``MeshExec`` serving (shard_map'd step functions over
    the pool's (data 2, model 4) axes, the host arrays replicated to both
    replicas) of both configs in f32 with ``attn_impl="ref"``, greedy
    and sampled, under xla and posh: qwen2-moe at the smoke capacity,
    qwen3-moe at capacity factor 1.0 (pairs drop, so capacity counted
    over both replicas' rows would keep others); the first prefill
    chunk's logits, shard by shard;
  * the reference's own tp = 1 engine on both configs, whose streams its
    TP engine must give (each replica routes the tp = 1 engine's rows,
    drops included).

Every reference case is its own jit, compiled on a thread pool; the
worker's CPU seconds (every thread's, compiles included) are bounded
and its wall time reported: inside a parallel test run the wall clock
measures the neighbours' load, not this worker's cost.

The port serves the same ``from_jax`` weights through ``shard_for_tp`` and
is held backend for backend: port xla to reference xla, port posh AND
pallas to reference posh.  ``moe_apply`` within 1e-5 x max |output| of
the reference (expert products summed in another order), port pallas ==
port posh bit for bit, port xla within rtol 1e-6 of port posh.  Streams
and token ids have no tolerance; the first-step logits are held within
1e-5 x max |logit|.  The port's own invariances on the no-drop smoke
configs: MoE TP == MoE tp = 1, alltoall == einsum, spec k = 2 ==
non-spec (n-gram, replay, fixed), 2+2 TP 2 cells == colocated TP 2.
"""
import dataclasses
import os
import resource
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DP, TP = 2, 4
ARCHS = ("qwen3-moe-30b-a3b", "qwen2-moe-a2.7b")
DROP_ARCH = "qwen3-moe-30b-a3b"          # the engine's capacity-dropping case
DROP_CF = 1.0
ENGINE_CF = {DROP_ARCH: DROP_CF}         # else the smoke capacity (no drops)
PROMPTS = [list(range(3, 11)), list(range(40, 46)), [7, 3, 99, 12, 55]]
SCFG = dict(page_tokens=4, n_pages=24, max_batch=3, max_seq=32,
            prefill_chunk=3)
SAMPLED = dict(temperature=0.8, top_k=5, top_p=0.9)
FIRST_BT = [[1, 2] + [0] * 6, [3, 4] + [0] * 6, [5, 6] + [0] * 6]
# moe_apply's inputs: 4 rows of 16 tokens, each row's last 6 a copy of
# one token (as a window's padded tail), so capacity factor 1.0 drops
MOE_X = dict(b=4, t=16, tail=10, seed=3)
MODULE_TPS = (2, 4)
DISPATCHES = ("einsum", "alltoall")
# moe_apply's (tp, capacity factor) cases: the smoke capacity at both
# tp, pairs dropped at tp 4
MODULE_CASES = ((2, None), (4, None), (4, DROP_CF))


def _stream_array(streams: dict) -> np.ndarray:
    return np.array([streams[i] for i in range(len(streams))], np.int32)


def _with_cf(cfg, cf):
    if cf is None:
        return cfg
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def _moe_x(d: int) -> np.ndarray:
    x = np.random.RandomState(MOE_X["seed"]).randn(
        MOE_X["b"], MOE_X["t"], d).astype(np.float32)
    x[:, MOE_X["tail"]:] = x[0, 0]
    return x


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
    from repro.models import embed as emb
    from repro.models import mlp as jmlp
    from repro.models import registry
    from repro.parallel.ctx import ParallelCtx, smap
    from repro.serve.engine import _make_window_forward

    mesh = compat.make_mesh((DP, TP), ("data", "model"))
    pool_spec = P("data", "model")
    f32 = dict(param_dtype=jnp.float32, compute_dtype=jnp.float32)
    out = {}

    def ctx_of(backend, dp=DP, tp=TP, dispatch="einsum"):
        return ParallelCtx(dp_size=dp, tp_size=tp, sp=False, remat=False,
                           backend=backend, moe_dispatch=dispatch, **f32)

    def module_cases(arch, cfg, params, tp, cf):
        """moe_apply on a (1, tp) mesh, each PE's output stacked: one
        program holds the dispatches and backends at one capacity."""
        p0 = jax.tree.map(lambda a: a[0], params["blocks"]["mlp"])
        ccf = _with_cf(cfg, cf)
        cases = [(d, b) for d in DISPATCHES for b in ("xla", "posh")]
        ctxs = [ctx_of(b, 1, tp, d) for d, b in cases]
        m1 = compat.make_mesh((1, tp), ("data", "model"),
                              devices=jax.devices()[:tp])

        def body(p, x):
            return tuple(jmlp.moe_apply(p, x, ctx, ccf)[None] for ctx in ctxs)

        got = jax.jit(smap(body, m1, (jmlp.moe_specs(cfg, ctxs[0]), P()),
                           (P("model"),) * len(cases)))(
            p0, jnp.asarray(_moe_x(cfg.d_model)))
        return {f"moe:{arch}:{tp}:{cf}:{d}:{b}": np.asarray(y)
                for (d, b), y in zip(cases, got)}

    class MeshExec:
        """The multi-PE serve suite's MeshExec: the step functions
        shard_map'd over the pool's (data, model) axes, the host arrays
        replicated to every replica; the host reads replica 0."""

        def __init__(self, api, params, cfg, backend, kv):
            ctx = ctx_of(backend)
            scfg = serve.ServeConfig(**SCFG, attn_impl="ref")
            self.params, self.kv = params, kv

            def wrap(f):
                def w(params, pool, a, b, c, d, samp):
                    toks, kvo = f(params, pool[0, 0], a, b, c, d, samp)
                    return toks, kvo[None, None]
                return jax.jit(smap(
                    w, mesh, (api.specs(cfg, ctx), pool_spec, P(), P(), P(),
                              P(), P()), (P("data"), pool_spec)))
            self._prefill = wrap(serve.make_prefill(cfg, ctx, scfg))
            self._decode = wrap(serve.make_decode_step(cfg, ctx, scfg))

        def _call(self, fn, pool, arrays, samp):
            toks, pool = fn(self.params, pool,
                            *(jnp.asarray(a) for a in arrays), samp)
            return np.asarray(toks).reshape(DP, -1)[0], pool

        def init_pool(self):
            return jnp.zeros((DP, TP) + self.kv.handle.shape,
                             self.kv.handle.dtype)

        def prefill(self, pool, ids, start, n_tok, bt, samp):
            return self._call(self._prefill, pool, (ids, start, n_tok, bt),
                              samp)

        def decode(self, pool, tokens, pos, bt, lens, samp):
            return self._call(self._decode, pool, (tokens, pos, bt, lens),
                              samp)

    def mesh_streams(arch, cfg, params, backend):
        """DP2 x TP4 serving at the arch's engine capacity, greedy and
        sampled, one compile serving both."""
        ccfg = _with_cf(cfg, ENGINE_CF.get(arch))
        scfg = serve.ServeConfig(**SCFG, attn_impl="ref")
        kv = serve.PagedKVCache(
            SymmetricHeap(("data", "model"), capacity_bytes=1 << 30),
            n_layers=ccfg.n_layers, kv_heads=ccfg.kv_per_rank(TP),
            head_dim=ccfg.head_dim, n_pages=scfg.n_pages,
            page_tokens=scfg.page_tokens)
        ex = MeshExec(registry.build(ccfg), params, ccfg, backend, kv)
        res = {}
        for tag, sp in (("greedy", serve.GREEDY),
                        ("sampled", serve.SamplingParams(**SAMPLED))):
            eng = serve.ServeEngine(params, ccfg, ctx_of(backend), scfg,
                                    kv=kv, exec_=ex)
            res[f"streams:{arch}:{backend}:{tag}"] = _requests_run(
                serve, eng, sp)
        return res

    def tp1_streams(arch, cfg, params):
        """The reference's own tp = 1 engine: each replica of its TP
        engine routes these rows, so it must give these streams."""
        eng = serve.ServeEngine(params, _with_cf(cfg, ENGINE_CF.get(arch)),
                                ctx_of("xla", 1, 1),
                                serve.ServeConfig(**SCFG, attn_impl="ref"))
        return {f"streams:{arch}:tp1": _requests_run(serve, eng,
                                                     serve.GREEDY)}

    def first_logits(arch, cfg, params):
        """The first prefill chunk's logits, each shard's V/tp columns."""
        ctx = ctx_of("xla")
        cfg = _with_cf(cfg, ENGINE_CF.get(arch))
        window = _make_window_forward(
            cfg, ctx, serve.ServeConfig(**SCFG, attn_impl="ref"))
        head = "embed" if cfg.tie_embeddings else "head"

        def first(params, pool, ids, start, n_tok, bt):
            x, _ = window(params, pool[0, 0], ids, start, n_tok, bt)
            return emb.lm_head_logits(params[head], x[:, -1], ctx)

        kv_shape = (SCFG["n_pages"], 2, cfg.n_layers, SCFG["page_tokens"],
                    cfg.kv_per_rank(TP), cfg.head_dim)
        ids = np.array([p[:3] for p in PROMPTS], np.int32)
        return {f"logits:{arch}": np.asarray(jax.jit(smap(
            first, mesh, (registry.build(cfg).specs(cfg, ctx), pool_spec,
                          P(), P(), P(), P()), P(None, "model")))(
                params, jnp.zeros((DP, TP) + kv_shape, jnp.float32),
                jnp.asarray(ids), jnp.zeros((3,), jnp.int32),
                jnp.full((3,), 3, jnp.int32),
                jnp.asarray(np.array(FIRST_BT, np.int32))))}

    # every case is its own jit; the compiles run on a thread pool (XLA
    # compiles without the GIL), which keeps the worker's wall time down
    # every case is its own jit; each arch's cases go to a thread pool
    # (XLA compiles without the GIL) as soon as its weights are drawn, the
    # longest first, while the next arch's weights are drawn
    futures = []
    with ThreadPoolExecutor(16) as pool:
        for arch in ARCHS:
            cfg = configs.get_smoke(arch)
            params = registry.build(cfg).init(jax.random.PRNGKey(0), cfg,
                                              ctx_of("xla", 1, 1))
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                    params)[0]:
                key = "/".join(str(k.key) for k in path)
                out[f"param:{arch}:{key}"] = np.asarray(leaf)
            common = (arch, cfg, params)
            futures += [pool.submit(mesh_streams, *common, b)
                        for b in ("xla", "posh")]
            futures += [pool.submit(module_cases, *common, *case)
                        for case in MODULE_CASES]
            futures += [pool.submit(f, *common)
                        for f in (tp1_streams, first_logits)]
        for fut in futures:
            out.update(fut.result())
    out["seconds"] = np.array(time.monotonic() - t_start)
    use = resource.getrusage(resource.RUSAGE_SELF)   # every thread's
    out["cpu_seconds"] = np.array(use.ru_utime + use.ru_stime)
    np.savez(out_path, **out)


def _requests_run(serve, eng, sampling) -> np.ndarray:
    done = eng.run([serve.Request(rid=i, prompt=list(p), max_new=6,
                                  sampling=sampling)
                    for i, p in enumerate(PROMPTS)], clock="tick")
    return _stream_array({r.rid: list(r.out) for r in done})


# ======================================================================
# the port's side
# ======================================================================
@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_moe_tp") / "ref.npz"
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
def weights(ref):
    """Each arch's smoke config and the reference's weights as full port
    parameters (``from_jax``)."""
    from repro_torch import configs
    from repro_torch.weights import from_jax

    out = {}
    for arch in ARCHS:
        tree: dict = {}
        prefix = f"param:{arch}:"
        for key, leaf in ref.items():
            if key.startswith(prefix):
                *path, name = key[len(prefix):].split("/")
                node = tree
                for p in path:
                    node = node.setdefault(p, {})
                node[name] = leaf
        out[arch] = (configs.get_smoke(arch), from_jax(tree))
    return out


def _ctx(backend, tp=TP, dispatch="einsum"):
    from repro_torch.parallel import ParallelCtx
    return ParallelCtx(tp_size=tp, backend=backend, moe_dispatch=dispatch)


def _twin(backend):
    """The reference backend a port backend is held to."""
    return "xla" if backend == "xla" else "posh"


def _kv(cfg, scfg, tp=TP):
    from repro_torch import serve
    from repro_torch.core.heap import SymmetricHeap
    return serve.PagedKVCache(
        SymmetricHeap(("data", "model")), n_layers=cfg.n_layers,
        kv_heads=cfg.kv_per_rank(tp), head_dim=cfg.head_dim,
        n_pages=scfg.n_pages, page_tokens=scfg.page_tokens)


def _requests(sampling=None):
    from repro_torch import serve
    sp = serve.GREEDY if sampling is None else serve.SamplingParams(**sampling)
    return [serve.Request(rid=i, prompt=list(p), max_new=6, sampling=sp)
            for i, p in enumerate(PROMPTS)]


def _serve(cfg, params, ctx=None, *, replicas=DP, sampling=None,
           proposer=None, **kw):
    """Streams of the prompts on a ServeEngine: a StackedExec of
    ``replicas`` TP groups (reading replica 0), or tp = 1 without a
    ctx."""
    from repro_torch import serve
    scfg = serve.ServeConfig(**{"attn_impl": "ref", **SCFG, **kw})
    ex = kv = None
    if ctx is not None:
        kv = _kv(cfg, scfg, ctx.tp_size)
        ex = serve.StackedExec(params, cfg, ctx, scfg, kv,
                               torch.device("cpu"), replicas=replicas)
    eng = serve.ServeEngine(params, cfg, scfg, ctx=ctx, exec_=ex, kv=kv,
                            device="cpu", proposer=proposer)
    done = eng.run(_requests(sampling), clock="tick")
    return {r.rid: list(r.out) for r in done}, eng


def _want(ref, key):
    return {i: [int(t) for t in row] for i, row in enumerate(ref[key])}


BACKENDS = ("xla", "posh", "pallas")
TAGS = (("greedy", None), ("sampled", SAMPLED))


def test_reference_worker_within_budget(ref):
    """The JAX worker's cost stays well inside the tier-1 budget: its CPU
    seconds, every thread's, compiles included (~160 alone), bounded at
    about twice that; its wall time (~46 s alone) is reported, not
    bounded — inside the driver's parallel run it measures the other
    workers' load.  The reference agrees with itself: its xla and posh
    meshes give the same streams, and its TP MoE engine gives its own
    tp = 1 engine's streams (each replica routes the tp = 1 rows)."""
    cpu, wall = float(ref["cpu_seconds"]), float(ref["seconds"])
    print(f"JAX worker: {cpu:.1f} CPU s, {wall:.1f} s of wall")
    assert cpu < 320, cpu
    for arch in ARCHS:
        for tag, _ in TAGS:
            np.testing.assert_array_equal(ref[f"streams:{arch}:xla:{tag}"],
                                          ref[f"streams:{arch}:posh:{tag}"])
        np.testing.assert_array_equal(ref[f"streams:{arch}:xla:greedy"],
                                      ref[f"streams:{arch}:tp1"])


# ======================================================================
# moe_apply at tp > 1
# ======================================================================
def _stacked_moe(weights, arch, tp, cf, dispatch, backend):
    """The port's layer-0 moe_apply on every PE's copy of the inputs:
    (output (tp, b, t, d), ctx)."""
    from repro_torch.models import lm, mlp
    from repro_torch.weights import shard_for_tp

    cfg, params = weights[arch]
    cfg = _with_cf(cfg, cf)
    p = lm.layer(shard_for_tp(params, cfg, tp)["blocks"], 0)["mlp"]
    x = torch.from_numpy(_moe_x(cfg.d_model))
    ctx = _ctx(backend, tp, dispatch)
    return mlp.moe_apply(p, x[None].expand(tp, *x.shape).contiguous(), cfg,
                         ctx), ctx


def _dropped(weights, arch, cf) -> int:
    """Pairs past capacity among the module inputs' n = b t tokens."""
    from repro_torch.models import lm, mlp

    cfg, params = weights[arch]
    m = _with_cf(cfg, cf).moe
    x = torch.from_numpy(_moe_x(cfg.d_model)).reshape(-1, cfg.d_model)
    _, idx = mlp.route(lm.layer(params["blocks"], 0)["mlp"]["router"], x,
                       cfg)
    ep = m.experts_padded(1)
    cap = int(x.shape[0] * m.top_k * m.capacity_factor / ep) + 1
    return int((mlp.positions_in_expert(idx, ep) >= cap).sum())


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("tp,cf", MODULE_CASES,
                         ids=[f"tp{t}-cf{8 if c is None else 1}"
                              for t, c in MODULE_CASES])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_equals_reference(ref, weights, arch, tp, cf, dispatch,
                                    backend):
    """Every PE's output of ``moe_apply`` at tp 2 and 4, einsum and
    alltoall, within 1e-5 x max |output| of the reference's twin
    backend, at the smoke capacity (nothing dropped) and, at tp 4, at
    1.0 (the stated number of pairs dropped); the step's collectives are the
    dispatch's: einsum one psum of the routed partials, alltoall two
    all_to_all and no psum of them; the shared expert one psum more."""
    got, ctx = _stacked_moe(weights, arch, tp, cf, dispatch, backend)
    want = ref[f"moe:{arch}:{tp}:{cf}:{dispatch}:{_twin(backend)}"]
    assert got.shape == want.shape == (tp, MOE_X["b"], MOE_X["t"],
                                       weights[arch][0].d_model)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))
    dropped = _dropped(weights, arch, cf)
    assert (dropped > 0) == (cf is not None), dropped   # 0 at cf 8
    st = ctx.tp_comm.stats()
    shared = bool(weights[arch][0].moe.shared_ff)
    assert st.get("psum", {}).get("calls", 0) == \
        (dispatch == "einsum") + shared
    assert st.get("all_to_all", {}).get("calls", 0) == \
        2 * (dispatch == "alltoall")


@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("cf", (None, DROP_CF), ids=["cf8", "cf1"])
@pytest.mark.parametrize("tp", MODULE_TPS)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_backends_agree(weights, arch, tp, cf, dispatch):
    """pallas == posh bit for bit (the same schedules, the copy kernel's
    plain version moving the payloads); xla within rtol 1e-6 of posh
    (another summation order of the same psum); every PE holds the same
    output."""
    out = {b: _stacked_moe(weights, arch, tp, cf, dispatch, b)[0]
           for b in BACKENDS}
    assert torch.equal(out["pallas"], out["posh"])
    np.testing.assert_allclose(out["xla"].numpy(), out["posh"].numpy(),
                               rtol=1e-6, atol=1e-6 * float(
                                   out["posh"].abs().max()))
    for b in BACKENDS:
        assert all(torch.equal(out[b][t], out[b][0]) for t in range(tp))


# ======================================================================
# shard_for_tp on MoE blocks
# ======================================================================
@pytest.mark.parametrize("tp", MODULE_TPS)
@pytest.mark.parametrize("arch", ARCHS)
def test_shard_for_tp_moe_layout(weights, arch, tp):
    """``moe_specs``: the experts split on their own axis, rank t owning
    experts ``t E/tp ..``, as views sharing the full tensors' storage;
    the router replicated (one copy a PE); the shared expert split by
    columns (``wu``/``wg``) and rows (``wd``)."""
    from repro_torch.weights import shard_for_tp

    cfg, params = weights[arch]
    full = params["blocks"]["mlp"]
    got = shard_for_tp(params, cfg, tp)["blocks"]["mlp"]
    ep = cfg.moe.experts_padded(tp)
    e_loc = ep // tp
    assert got["router"].shape == (cfg.n_layers, tp) + \
        full["router"].shape[1:]
    for t in range(tp):
        assert torch.equal(got["router"][:, t], full["router"])
    for name in ("wu", "wg", "wd"):
        w = got[name]
        assert w.shape == (cfg.n_layers, tp, e_loc) + full[name].shape[2:]
        assert w.untyped_storage().data_ptr() == \
            full[name].untyped_storage().data_ptr()
        for t in range(tp):
            assert torch.equal(w[:, t], full[name][:, t * e_loc:
                                                   (t + 1) * e_loc])
    if cfg.moe.shared_ff:
        sh, fs = got["shared"], full["shared"]
        f = cfg.moe.shared_ff // tp
        assert sh["wd"].untyped_storage().data_ptr() == \
            fs["wd"].untyped_storage().data_ptr()
        for t in range(tp):
            for name in ("wu", "wg"):
                assert torch.equal(sh[name][:, t],
                                   fs[name][..., t * f:(t + 1) * f])
            assert torch.equal(sh["wd"][:, t], fs["wd"][:, t * f:(t + 1) * f])
    else:
        assert "shared" not in got


@pytest.mark.parametrize("what", ["experts", "shared", "padding"])
def test_shard_for_tp_moe_refusals(weights, what):
    """Experts that do not divide by tp, a shared expert whose ff does
    not, and experts the reference would pad otherwise at tp than at 1
    raise, naming the dimension."""
    from repro_torch.weights import shard_for_tp

    cfg, params = weights["qwen2-moe-a2.7b"]
    moe = {"experts": dict(num_experts=6, padded_experts=6),
           "shared": dict(shared_ff=90),
           "padding": dict(num_experts=7, padded_experts=None)}[what]
    bad = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
    match = {"experts": "experts do not divide", "shared": "shared expert",
             "padding": "pads"}[what]
    with pytest.raises(ValueError, match=match):
        shard_for_tp(params, bad, 4)


# ======================================================================
# engine level: DP2 x TP4 against the reference's mesh serving
# ======================================================================
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("tag,sampling", TAGS)
@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_dp2_tp4_streams_equal_reference(ref, weights, arch, dispatch, tag,
                                         sampling, backend):
    """The DP2 x TP4 streams, greedy and sampled, equal the reference's
    (einsum) mesh's on the twin backend under either dispatch (alltoall
    keeps the same pairs); the step went through the communicator: the
    embed's psum and, a layer, the attention's, the routed experts'
    (einsum) and the shared expert's; two all_to_all a layer under
    alltoall; one top-k merge a step.  qwen3-moe serves at capacity
    factor 1.0, where pairs drop: the reference's replicas each route
    only their own three rows, and counting the capacity over both
    replicas' six rows would keep other pairs and give other streams."""
    from repro_torch.models import mlp

    cfg, params = weights[arch]
    cfg = _with_cf(cfg, ENGINE_CF.get(arch))
    drops = []
    slots0 = mlp.positions_in_expert

    def slots(idx_k, n_experts):
        pos = slots0(idx_k, n_experts)
        n = idx_k.shape[-2]
        cap = int(n * cfg.moe.top_k * cfg.moe.capacity_factor
                  / n_experts) + 1
        drops.append(int((pos >= cap).sum()))
        return pos

    mlp.positions_in_expert = slots
    try:
        got, eng = _serve(cfg, params, _ctx(backend, dispatch=dispatch),
                          sampling=sampling)
    finally:
        mlp.positions_in_expert = slots0
    assert (sum(drops) > 0) == (arch == DROP_ARCH), sum(drops)
    assert got == _want(ref, f"streams:{arch}:{_twin(backend)}:{tag}")
    st, steps = eng.ctx.tp_comm.stats(), sum(eng.steps.values())
    per_layer = 1 + bool(cfg.moe.shared_ff) + (dispatch == "einsum")
    assert st["psum"]["calls"] == steps * (1 + per_layer * cfg.n_layers)
    assert st.get("all_to_all", {}).get("calls", 0) == \
        (2 * cfg.n_layers * steps if dispatch == "alltoall" else 0)
    assert st["top_k_merge"]["calls"] == steps


@pytest.mark.parametrize("arch", ARCHS)
def test_first_step_logits_equal_reference(ref, weights, arch):
    """The first prefill chunk's logits, shard by shard, within 1e-5 x max
    |logit| of the reference's TP4 shards."""
    from repro_torch import serve
    from repro_torch.models import embed as emb
    from repro_torch.serve import engine as se

    cfg, params = weights[arch]
    cfg = _with_cf(cfg, ENGINE_CF.get(arch))
    ctx = _ctx("xla")
    scfg = serve.ServeConfig(**SCFG, attn_impl="ref")
    ex = serve.StackedExec(params, cfg, ctx, scfg, _kv(cfg, scfg),
                           torch.device("cpu"), replicas=1)
    window = se._make_window_forward(cfg, scfg, ctx)
    x, _ = window(ex.params, ex.init_pool(),
                  torch.tensor([p[:3] for p in PROMPTS], dtype=torch.int32),
                  torch.zeros(3, dtype=torch.int32),
                  torch.full((3,), 3, dtype=torch.int32),
                  torch.tensor(FIRST_BT, dtype=torch.int32))
    head = ex.params["embed" if cfg.tie_embeddings else "head"]
    got = emb.lm_head_logits(head, x[:, :, -1], ctx)
    want = ref[f"logits:{arch}"].reshape(3, TP, -1).transpose(1, 0, 2)
    assert got.shape == want.shape
    tol = 1e-5 * float(np.abs(want).max())
    for t in range(TP):
        np.testing.assert_allclose(got[t].numpy(), want[t], rtol=0, atol=tol)


# ======================================================================
# the port's own invariances (smoke capacity: nothing drops)
# ======================================================================
@pytest.fixture(scope="module")
def tp1_streams(weights):
    return {arch: _serve(*weights[arch])[0] for arch in ARCHS}


@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("tp", MODULE_TPS)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_tp_equals_tp1(weights, tp1_streams, arch, tp, dispatch):
    """One TP group (posh) of 2 or 4 PEs serves the tp = 1 streams."""
    got, _ = _serve(*weights[arch], _ctx("posh", tp, dispatch), replicas=1)
    assert got == tp1_streams[arch]


@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_k2_equals_non_spec(weights, tp1_streams, arch, dispatch):
    """spec k = 2 (n-gram) at DP2 x TP4 under posh: the non-speculative
    streams through the verify window."""
    got, eng = _serve(*weights[arch], _ctx("posh", dispatch=dispatch),
                      spec_k=2)
    assert got == tp1_streams[arch]
    assert eng.spec_stats["verify_ticks"] > 0 and eng.steps["decode"] == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_replay_accepts_and_fixed_rewinds(weights, tp1_streams, arch):
    """Under a MoE TP target (DP2 x TP4, posh, alltoall) a replay of the
    streams accepts every draft and a fixed proposer of tokens no stream
    holds accepts none (pages rewound); both give the non-speculative
    streams."""
    from repro_torch import serve

    cfg, params = weights[arch]
    want = tp1_streams[arch]
    ctx = _ctx("posh", dispatch="alltoall")
    got, eng = _serve(cfg, params, ctx, spec_k=2,
                      proposer=serve.ReplayProposer(want))
    assert got == want and eng.metrics()["spec"]["accept_rate"] == 1.0
    absent = [t for t in range(cfg.vocab)
              if all(t not in out for out in want.values())][:2]
    got, eng = _serve(cfg, params, _ctx("posh", dispatch="alltoall"),
                      spec_k=2, proposer=serve.FixedProposer(absent))
    assert got == want and eng.spec_stats["accepted"] == 0
    assert eng.kv.stats["rewound_pages"] > 0


@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_disagg_2p2_tp2_equals_colocated(weights, arch, dispatch):
    """2+2 prefill/decode cells of one TP 2 group each (posh) serve the
    colocated TP 2 engine's streams, over one stacked weights dict."""
    from repro_torch import serve

    cfg, params = weights[arch]
    ctx = _ctx("posh", 2, dispatch)
    want, _ = _serve(cfg, params, ctx, replicas=1)
    eng = serve.DisaggEngine(params, cfg, serve.ServeConfig(**SCFG,
                                                            attn_impl="ref"),
                             ctx=ctx, device="cpu", n_prefill=2, n_decode=2)
    done = eng.run(_requests(), clock="tick")
    assert {r.rid: list(r.out) for r in done} == want
    stacked = {id(c.exec.params["blocks"]["mlp"]["wu"]) for c in eng.engines}
    assert len(stacked) == 1
    assert eng.stats()["handoff_quiets"] == 0


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("tp", MODULE_TPS)
@pytest.mark.parametrize("arch", ARCHS)
def test_build_engine_serves_moe_tp(arch, tp, dispatch,
                                    backend):
    """``build_engine(arch, ctx=ParallelCtx(tp_size=T, backend=B,
    moe_dispatch=D))`` builds and serves at every T, B and D, on weights
    drawn from the seed, the tp = 1 build's streams."""
    from repro_torch.launch import serve as launch

    kw = dict(config="smoke", dtype="f32", device="cpu", page_tokens=4,
              n_pages=24, max_batch=3, prefill_chunk=3, attn_impl="ref")
    out = {}
    for ctx in (None, _ctx(backend, tp, dispatch)):
        eng, cfg = launch.build_engine(arch, ctx=ctx, **kw)
        done = eng.run(_requests(), clock="tick")
        out[ctx is None] = {r.rid: list(r.out) for r in done}
    assert eng.ctx.tp_size == tp and eng.ctx.moe_dispatch == dispatch
    assert out[False] == out[True]


if __name__ == "__main__" and "--jax-worker" in sys.argv:
    _jax_worker(sys.argv[sys.argv.index("--jax-worker") + 1])
