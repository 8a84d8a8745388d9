"""Data-parallel training on the stacked team (``ParallelCtx(dp_size=N)``)
against the JAX reference's ``(data, 1)`` meshes.

The reference trains under ``smap`` on a mesh of 2 or 8 CPU devices,
which must be set before JAX starts; so this file re-executes itself in
a subprocess (``--jax-worker``) with
``XLA_FLAGS=--xla_force_host_platform_device_count=8``, as
``test_torch_tp.py`` does.  The worker compiles every reference program
on a thread pool and writes weights, reductions, trajectories and a
checkpoint to a directory; the port runs the same inputs with the
kernels' plain versions (the CPU).

Held to the reference:

  (1) ``plan_buckets`` on mixed-dtype trees (f32 / bf16 / int32);
  (2) ``bucketed_allreduce`` and ``tree_pmean`` at team 8, and
  (3) ``compressed_allreduce`` (bf16, int8) over 3 error-feedback steps:
      port posh and pallas bit for bit to reference posh, port xla to
      reference xla within rtol 1e-6 and 1e-6 of the output's largest
      magnitude (the port's xla psum sums in another order than XLA's,
      and a cancelling sum's error scales with its terms; in bf16, 2^-8
      for both: one bf16 ulp); int8 under every backend within 2^-20 of
      the step's largest input (XLA's CPU code fuses the residual's
      multiply and subtract into one FMA, one rounding where the port
      has two, and sums the local einsum in another order);
  (5) 3-step trajectories of smoke gemma-2b in f32 at dp 2 (per-leaf
      under xla and posh; bucketed (2048 B), ``compress="bf16"`` and
      ZeRO-1 under posh) and smoke qwen3-8b at dp 8 (bucketed and
      ZeRO-1 under posh), the port's overlapped runs held to the
      blocking ones, port pallas to reference posh: the loss and
      ``grad_norm`` within rtol 1e-5 (``grad_norm`` of the bf16 case
      within 1e-4: a gradient 1e-7 off may round to the next bf16 on the
      wire; its parameters within atol 0.01 x lr, as such a rounding
      moves Adam's step by ~2^-8 x lr a step), the parameters after the
      steps within rtol 2e-4 / atol 2e-5 on every element whose Adam
      denominator (the bias-corrected rms of its clipped gradients)
      stayed above 1e-4, the others within 0.1 x lr (the rule of
      ``test_torch_train.py``: there a small gradient's own rounding
      moves its parameter by up to ~2e-4); no other tolerance;
  (8) ZeRO-1 at dp 2: the clip is replica-local and ``grad_norm`` is
      replica 0's, as the reference's; a padded leaf's tail stays 0;
  (9) the DP 2 ZeRO-1 state in the reference's layout
      (``state_to_tree``) leaf for leaf, and a JAX DP 2 checkpoint
      (``repro.ckpt.Checkpointer``) resumed by the port, continuing with
      the reference's losses.

In the port alone: (4) the reference's own compression and bucketing
properties (``tests/test_train.py``); (6) overlapped == blocking and
pallas == posh bit for bit, and every reduced row equal to row 0 under
every backend and schedule; (7) DP 2 equal to dp 1 on the same global
batch within rtol 1e-5, and 2 microbatches a replica equal to 1.
"""
import os
import resource
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 5e-3
STEPS = 3
BUCKET = 2048
CASES = {
    "leaf": {},
    "bucket": {"bucket_bytes": BUCKET},
    "overlap_leaf": {"overlap_grad_sync": True},
    "overlap_bucket": {"overlap_grad_sync": True, "bucket_bytes": BUCKET},
    "bf16": {"compress": "bf16"},
    "zero1": {"zero": 1},
    "mb2": {"microbatches": 2},
}
# the reference's runs: (arch, dp, case, backend).  Each costs 15-40 s
# of CPU (trace and compile), and the worker shares the tier-1 run's
# cores with other suites, so the set is the least that reaches every
# reduction schedule, both archs, dp 2 and 8 and both backends.  The
# reference's overlapped programs are its blocking ones bit for bit (its
# own suite asserts it: tests/multipe/run_ordering.py), so the port's
# overlapped runs are held to the reference's blocking runs
# (``_ref_case``); microbatching at dp 2 is held to the port's own
# single-microbatch run, as tests/test_train.py holds the reference's.
RUNS = tuple((arch, dp, case, backend)
             for arch, dp, cases, backends in (
                 ("gemma-2b", 2, ("leaf",), ("xla", "posh")),
                 ("gemma-2b", 2, ("bucket", "bf16", "zero1"), ("posh",)),
                 ("qwen3-8b", 8, ("bucket", "zero1"), ("posh",)))
             for case in cases for backend in backends)
CKPT_RUN = ("gemma-2b", 2, "zero1", "posh")     # checkpointed after step 1
RED_BYTES = (64, 40000)   # the team-8 buckets: one leaf each; merged
EF_STEPS = 3


def _key(run) -> str:
    return ":".join(str(x) for x in run)


def _batch(case) -> int:
    """The global batch: 8 rows a microbatch step (dp 8 x mb 2 at 16)."""
    return 8 * CASES[case].get("microbatches", 1)


def _red_tree(seed=0) -> dict:
    """The team-8 reduction input: every PE's leaves stacked (8, ...), f32
    leaves across both sides of the eager/ring threshold."""
    rng = np.random.RandomState(seed)
    return {"a": rng.randn(8, 3000).astype(np.float32),
            "b": rng.randn(8, 7, 5).astype(np.float32),
            "c": rng.randn(8, 9000).astype(np.float32),
            "d": {"e": rng.randn(8, 33).astype(np.float32)}}


def _pad_params(seed=1) -> dict:
    """A tree whose leaves do not divide by dp = 2 (7 and 15 elements)."""
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(7).astype(np.float32),
            "u": rng.randn(3, 5).astype(np.float32)}


def _pad_grads(seed=2) -> np.ndarray:
    rng = np.random.RandomState(seed)
    return [{"w": rng.randn(2, 7).astype(np.float32),
             "u": rng.randn(2, 3, 5).astype(np.float32)}
            for _ in range(EF_STEPS)]


# ======================================================================
# the JAX worker (a subprocess with 8 CPU devices)
# ======================================================================
def _jax_worker(out_dir: str, shard: int, n_shards: int) -> None:
    t_start = time.monotonic()
    # the lowest priority: the compiles take idle cores, so the other
    # suites (and workers that time themselves) are not slowed by these
    os.nice(19)
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro import comm, compat, configs
    from repro.ckpt import Checkpointer
    from repro.data import SyntheticLM
    from repro.models import registry
    from repro.parallel.ctx import ParallelCtx, smap
    from repro.train.optimizer import AdamWConfig, adamw_init, adamw_update
    from repro.train.step import make_train_step, train_state_specs

    f32 = dict(param_dtype=jnp.float32, compute_dtype=jnp.float32)
    out = {}

    def ctx_of(dp, backend="xla"):
        return ParallelCtx(dp_size=dp, tp_size=1, sp=False, remat=True,
                           backend=backend, **f32)

    def flat(prefix, tree):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                           for k in path)
            out[f"{prefix}{key}"] = np.asarray(leaf)

    def trajectory(run, cfg, api, params):
        arch, dp, case, backend = run
        kw = dict(CASES[case])
        opt = AdamWConfig(lr=LR, zero=kw.pop("zero", 0))
        ctx = ctx_of(dp, backend)
        mesh = compat.make_mesh((dp, 1), ("data", "model"))
        sspecs = train_state_specs(cfg, ctx, api, opt)
        if opt.zero:
            init = jax.jit(smap(lambda p: adamw_init(p, ctx, opt), mesh,
                                (api.specs(cfg, ctx),), sspecs["opt"]))
            opt_state = init(params)
        else:                       # zero 0: m and v replicated zeros
            zeros = jax.tree.map(jnp.zeros_like, params)
            opt_state = {"m": zeros, "v": zeros,
                         "count": jnp.zeros((), jnp.int32)}
        state = {"params": params, "opt": opt_state,
                 "step": jnp.zeros((), jnp.int32)}
        fn = jax.jit(smap(make_train_step(cfg, ctx, api, opt, **kw), mesh,
                          (sspecs, {"tokens": P("data")}),
                          (sspecs, {"loss": P(), "grad_norm": P(),
                                    "step": P()})))
        data = SyntheticLM(vocab=cfg.vocab, seq_len=cfg.max_seq,
                           global_batch=_batch(case))
        metrics, rmin = [], None
        for s in range(STEPS):
            state, m = fn(state, data.batch(s))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
            if run == CKPT_RUN and s == 0:
                ck = Checkpointer(os.path.join(out_dir, "ckpt"), keep=3)
                ck.save_async(1, state)
                ck.wait()
            # Adam's bias-corrected rms of the gradients, in each
            # parameter's shape (ZeRO-1: the global view's first numel)
            bc2 = 1 - opt.b2 ** (s + 1)
            rms = jax.tree.map(
                lambda v, p: np.sqrt(np.asarray(v).reshape(-1)[:p.size]
                                     .reshape(p.shape) / bc2),
                state["opt"]["v"], state["params"])
            rms = jax.tree.map(lambda r: np.where(r > 0, r, np.inf), rms)
            rmin = rms if rmin is None else jax.tree.map(np.minimum, rmin,
                                                         rms)
        res = {f"run:{_key(run)}:metrics": np.array(metrics)}
        for prefix, tree in ((f"run:{_key(run)}:param:", state["params"]),
                             (f"run:{_key(run)}:rmin:", rmin)):
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
                key = "/".join(str(k.key) for k in path)
                res[prefix + key] = np.asarray(leaf)
        if run == CKPT_RUN:
            leaves = jax.tree.leaves(state)
            res.update({f"state:{i}": np.asarray(x)
                        for i, x in enumerate(leaves)})
        return res

    def reductions(backend):
        """bucketed_allreduce / tree_pmean at team 8, stacked in and out."""
        mesh = compat.make_mesh((8,), ("pe",))
        tree = jax.tree.map(jnp.asarray, _red_tree())
        spec = jax.tree.map(lambda _: P("pe"), tree)
        res = {}

        def on_pe(f):
            def body(t):
                t = jax.tree.map(lambda x: x[0], t)
                return jax.tree.map(lambda x: x[None], f(t))
            return jax.jit(smap(body, mesh, (spec,), spec))

        c = comm.make_communicator("pe", size=8, backend=backend)
        for nb in RED_BYTES:
            got = on_pe(lambda t: comm.bucketed_allreduce(
                t, c, bucket_bytes=nb))(tree)
            for k, v in jax.tree_util.tree_flatten_with_path(got)[0]:
                res[f"red:bucket{nb}:{backend}:{jax.tree_util.keystr(k)}"] \
                    = np.asarray(v)
        got = on_pe(c.tree_pmean)(tree)
        for k, v in jax.tree_util.tree_flatten_with_path(got)[0]:
            res[f"red:pmean:{backend}:{jax.tree_util.keystr(k)}"] = \
                np.asarray(v)
        for scheme in ("bf16", "int8"):
            g = {"w": jnp.asarray(_red_tree()["a"]),
                 "x": jnp.asarray(_red_tree()["b"])}
            gspec = jax.tree.map(lambda _: P("pe"), g)

            def ef(t, r, scheme=scheme):
                t = jax.tree.map(lambda x: x[0], t)
                r = jax.tree.map(lambda x: x[0], r)
                o, st = comm.compressed_allreduce(
                    t, c, scheme=scheme,
                    state=comm.CompressionState(residual=r), mean=True)
                return (jax.tree.map(lambda x: x[None], o),
                        jax.tree.map(lambda x: x[None], st.residual))

            f = jax.jit(smap(ef, mesh, (gspec, gspec), (gspec, gspec)))
            resid = jax.tree.map(jnp.zeros_like, g)
            for k in range(EF_STEPS):
                o, resid = f(jax.tree.map(lambda x: x * (k + 1), g), resid)
                for name in ("w", "x"):
                    res[f"comp:{scheme}:{backend}:{k}:out:{name}"] = \
                        np.asarray(o[name])
                    res[f"comp:{scheme}:{backend}:{k}:res:{name}"] = \
                        np.asarray(resid[name])
        return res

    def zero1_pad():
        """adamw_update at zero 1, dp 2, on leaves that pad."""
        ctx = ctx_of(2, "posh")
        opt = AdamWConfig(lr=LR, zero=1)
        mesh = compat.make_mesh((2, 1), ("data", "model"))
        params = jax.tree.map(jnp.asarray, _pad_params())
        pspec = jax.tree.map(lambda _: P(), params)
        gspec = jax.tree.map(lambda _: P("data"), params)
        ospec = {"m": jax.tree.map(lambda _: P(("data", "model")), params),
                 "v": jax.tree.map(lambda _: P(("data", "model")), params),
                 "master": jax.tree.map(lambda _: P(("data", "model")),
                                        params), "count": P()}
        st = jax.jit(smap(lambda p: adamw_init(p, ctx, opt), mesh,
                          (pspec,), ospec))(params)

        def upd(p, g, s):
            g = jax.tree.map(lambda x: x[0], g)
            return adamw_update(p, g, s, ctx, opt)

        f = jax.jit(smap(upd, mesh, (pspec, gspec, ospec), (pspec, ospec)))
        for g in _pad_grads():
            params, st = f(params, jax.tree.map(jnp.asarray, g), st)
        res = {}
        for name, tree in (("param", params), ("m", st["m"]),
                           ("v", st["v"]), ("master", st["master"])):
            for k in ("w", "u"):
                res[f"pad:{name}:{k}"] = np.asarray(tree[k])
        return res

    # this shard's tasks go to a thread pool (XLA compiles without the
    # GIL; the tracing holds it, hence the shards' processes)
    tasks = _shard_tasks(shard, n_shards)
    models = {}
    futures = []
    with ThreadPoolExecutor(2) as pool:
        for task in tasks:
            if task[0] == "red":
                futures.append(pool.submit(reductions, task[1]))
            elif task[0] == "pad":
                futures.append(pool.submit(zero1_pad))
            else:
                arch = task[0]
                if arch not in models:
                    cfg = configs.get_smoke(arch)
                    api = registry.build(cfg)
                    models[arch] = (cfg, api, api.init(
                        jax.random.PRNGKey(0), cfg, ctx_of(1)))
                    flat(f"param:{arch}:", models[arch][2])
                futures.append(pool.submit(trajectory, task, *models[arch]))
        for fut in futures:
            out.update(fut.result())
    use = resource.getrusage(resource.RUSAGE_SELF)   # every thread's
    out["seconds"] = np.array(time.monotonic() - t_start)
    out["cpu_seconds"] = np.array(use.ru_utime + use.ru_stime)
    np.savez(os.path.join(out_dir, f"ref{shard}.npz"), **out)


N_SHARDS = 3


def _shard_tasks(shard: int, n_shards: int) -> list:
    """The worker's tasks, heaviest first (a posh program at dp 8 traces
    the most rounds), dealt round-robin to the shards."""
    tasks = [("red", "xla"), ("red", "posh"), ("pad",)] + list(RUNS)

    def weight(t):
        if t[0] in ("red", "pad"):
            return 1
        return t[1] * (2 if t[3] == "posh" else 1) + (t[2] == "zero1")
    tasks.sort(key=weight, reverse=True)
    return tasks[shard::n_shards]


# ======================================================================
# the port's side
# ======================================================================
@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("jax_dp")
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--jax-worker",
         str(out_dir), str(k), str(N_SHARDS)], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for k in range(N_SHARDS)]
    data = {}
    try:
        for k, proc in enumerate(procs):
            log = proc.communicate(timeout=600)[0]
            assert proc.returncode == 0, log[-4000:]
            with np.load(out_dir / f"ref{k}.npz") as z:
                data.update({key: z[key] for key in z.files
                             if key not in ("seconds", "cpu_seconds")})
                data[f"seconds:{k}"] = z["seconds"]
                data[f"cpu_seconds:{k}"] = z["cpu_seconds"]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    data["ckpt_dir"] = str(out_dir / "ckpt")
    return data


def _params_np(ref, arch) -> dict:
    tree: dict = {}
    prefix = f"param:{arch}:"
    for key, leaf in ref.items():
        if key.startswith(prefix):
            *path, name = key[len(prefix):].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[name] = leaf
    return tree


def _ctx(dp, backend):
    from repro_torch.parallel import ParallelCtx
    return ParallelCtx(dp_size=dp, backend=backend, remat=True,
                       param_dtype=torch.float32, compute_dtype=torch.float32)


def _twin(backend):
    """The reference backend a port backend is held to."""
    return "xla" if backend == "xla" else "posh"


def _port_state(ref, arch, dp, backend, case, **extra):
    """A port state, step and data of ``case``, ``extra`` step options
    on top of the case's."""
    from repro_torch import configs
    from repro_torch.data import SyntheticLM
    from repro_torch.models import registry
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.step import train_state_from
    from repro_torch.weights import from_jax

    kw = {**CASES[case], **extra}
    cfg = configs.get_smoke(arch)
    ctx = _ctx(dp, backend)
    opt = AdamWConfig(lr=LR, zero=kw.pop("zero", 0))
    state = train_state_from(from_jax(_params_np(ref, arch)), ctx, opt)
    step = make_train_step(cfg, ctx, registry.build(cfg), opt, **kw)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=cfg.max_seq,
                       global_batch=_batch(case))
    return state, step, data, ctx


def _port_run(ref, arch, dp, case, backend, extra):
    """The port's 3 steps: metrics and the final state tree (the
    reference's layout).  ``extra`` are more step options."""
    from repro_torch.train import state_to_tree

    state, step, data, _ = _port_state(ref, arch, dp, backend, case,
                                       **extra)
    metrics = []
    for s in range(STEPS):
        state, m = step(state, data.batch(s, device="cpu"))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        assert m["step"] == s + 1
    return np.array(metrics), state_to_tree(state)


@pytest.fixture(scope="module")
def port(ref):
    """The port's runs, each run once for the module."""
    cache = {}

    def run(arch, dp, case, backend, **extra):
        key = (arch, dp, case, backend, tuple(sorted(extra.items())))
        if key not in cache:
            cache[key] = _port_run(ref, arch, dp, case, backend, extra)
        return cache[key]
    return run


def test_reference_worker_within_budget(ref):
    """The JAX workers' cost stays inside the tier-1 budget: their CPU
    seconds, compiles included (~230 together alone; their wall time is
    the idle cores' at the lowest priority, ~45 s alone, 140-160 s in the
    driver's 6-worker run, so it is reported, not bounded); the
    reference's xla and posh runs agree."""
    cpu = [float(ref[f"cpu_seconds:{k}"]) for k in range(N_SHARDS)]
    wall = [float(ref[f"seconds:{k}"]) for k in range(N_SHARDS)]
    print(f"JAX workers: {cpu} CPU s, {wall} s of wall")
    assert sum(cpu) < 480, cpu             # twice their cost alone
    for arch, dp, case, backend in RUNS:
        if backend == "xla" and (arch, dp, case, "posh") in RUNS:
            np.testing.assert_allclose(
                ref[f"run:{_key((arch, dp, case, 'xla'))}:metrics"],
                ref[f"run:{_key((arch, dp, case, 'posh'))}:metrics"],
                rtol=1e-5)


# ----------------------------------------------------------------------
# (1) bucket plans
# ----------------------------------------------------------------------
def _mixed_tree(rng, n_pe):
    """A mixed-dtype tree, f32 / bf16 / int32 leaves interleaved."""
    shapes = {"a": ((5, 7), "f32"), "b": ((33,), "bf16"),
              "c": ((4, 4, 3), "i32"), "d": ((300,), "f32"),
              "e": {"f": ((2, 9), "bf16"), "g": ((1,), "f32"),
                    "h": ((64,), "i32")}, "k": ((128,), "f32")}

    def make(spec):
        if isinstance(spec, dict):
            return {k: make(v) for k, v in spec.items()}
        shape, dt = spec
        x = rng.randn(n_pe, *shape) * 10
        return {"f32": x.astype(np.float32), "bf16": x.astype(np.float32),
                "i32": x.astype(np.int32)}[dt], dt
    return make(shapes)


@pytest.mark.parametrize("bucket_bytes", [1, 64, 200, 1024, 1 << 20])
def test_plan_buckets_equal_the_reference(bucket_bytes):
    import jax.numpy as jnp
    from repro.comm import bucketing as jb

    from repro_torch.comm import bucketing as tb
    from repro_torch.tree import leaves

    tree = _mixed_tree(np.random.RandomState(0), 4)
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16, "i32": torch.int32}
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16, "i32": jnp.int32}

    def conv(t, f):
        if isinstance(t, dict):
            return {k: conv(v, f) for k, v in t.items()}
        return f(*t)

    port_tree = conv(tree, lambda x, dt: torch.from_numpy(x).to(tdt[dt]))
    ref_tree = conv(tree, lambda x, dt: jnp.asarray(x[0]).astype(jdt[dt]))
    import jax
    want = jb.plan_buckets(jb.leaf_metas(jax.tree.leaves(ref_tree)),
                           bucket_bytes)
    metas = tb.leaf_metas(leaves(port_tree))
    assert tb.plan_buckets(metas, bucket_bytes) == want
    assert [(m[0], m[2]) for m in metas] == [
        (tuple(x.shape), x.size) for x in jax.tree.leaves(ref_tree)]


# ----------------------------------------------------------------------
# (2), (3) the team-8 reductions
# ----------------------------------------------------------------------
def _stacked(tree):
    return {k: _stacked(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def _hold(got, want, backend, bf16=False, scale=None):
    got = got.float().numpy()
    if scale is not None:
        np.testing.assert_allclose(got, want, rtol=0, atol=scale)
        return
    if backend == "xla":
        # a sum in another order: its error scales with the terms, so a
        # cancelling sum is held to the output's scale as well
        tol = 2 ** -8 if bf16 else 1e-6
        np.testing.assert_allclose(got, want, rtol=tol,
                                   atol=tol * np.abs(want).max())
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backend", ["xla", "posh", "pallas"])
@pytest.mark.parametrize("how", ["bucket64", "bucket40000", "pmean"])
def test_team8_reductions_equal_the_reference(ref, backend, how):
    """bucketed_allreduce (64 B buckets: one leaf each; 40000 B: two
    buckets, both on the ring) and tree_pmean at team 8; with a heap
    bound the registry fingerprint is unchanged after."""
    from repro_torch.comm import make_communicator
    from repro_torch.core.heap import SymmetricHeap
    from repro_torch.tree import leaves

    heap = SymmetricHeap(("pe",))
    heap.alloc("resident", (16,), torch.float32)
    before = heap.fingerprint()
    comm = make_communicator("pe", size=8, backend=backend, heap=heap)
    tree = _stacked(_red_tree())
    if how == "pmean":
        got = comm.tree_pmean(tree)
    else:
        got = comm.bucketed_psum(tree, bucket_bytes=int(how[6:]))
        calls = comm.stats()["psum"]["calls"]
        assert calls == (4 if how == "bucket64" else 2), calls
    assert heap.fingerprint() == before
    keys = sorted(k for k in ref if k.startswith(f"red:{how}:{_twin(backend)}:"))
    assert len(keys) == len(leaves(tree)) == 4
    for key, g in zip(keys, leaves(got)):
        assert tuple(g.shape) == ref[key].shape
        _hold(g, ref[key], backend)


@pytest.mark.parametrize("backend", ["xla", "posh", "pallas"])
@pytest.mark.parametrize("scheme", ["bf16", "int8"])
def test_compressed_allreduce_equals_the_reference(ref, backend, scheme):
    """Three error-feedback steps (gradient k x g at step k): outputs and
    residuals; bf16 by the backends' rule, int8 within 2^-20 of the
    step's largest input magnitude under every backend."""
    from repro_torch.comm import (CompressionState, compressed_allreduce,
                                  make_communicator)

    comm = make_communicator("pe", size=8, backend=backend)
    g = {"w": torch.from_numpy(_red_tree()["a"]),
         "x": torch.from_numpy(_red_tree()["b"])}
    st = CompressionState.init(g, enabled=True)
    for k in range(EF_STEPS):
        gk = {n: v * (k + 1) for n, v in g.items()}
        gin = {n: float((v + st.residual[n]).abs().max())
               for n, v in gk.items()}
        out, st = compressed_allreduce(gk, comm, scheme=scheme, state=st,
                                       mean=True)
        for name in ("w", "x"):
            tag = f"comp:{scheme}:{_twin(backend)}:{k}"
            # int8: XLA's CPU code fuses the residual's multiply and
            # subtract into one FMA (one rounding, two here) and sums the
            # einsum in another order: 16 units of 2^-24 x max |input|
            scale = 2 ** -20 * gin[name] if scheme == "int8" else None
            # bf16 on the wire: the xla psum rounds its bf16 sum once
            _hold(out[name], ref[f"{tag}:out:{name}"], backend, bf16=True,
                  scale=scale)
            _hold(st.residual[name], ref[f"{tag}:res:{name}"], backend,
                  bf16=True, scale=scale)


# ----------------------------------------------------------------------
# (4) the reference's compression and bucketing properties on the port
# ----------------------------------------------------------------------
def test_bucketed_allreduce_identity_on_1pe():
    from repro_torch.comm import bucketed_allreduce
    tree = {"a": torch.arange(100.0)[None], "b": torch.ones((1, 7, 3)),
            "c": torch.arange(5, dtype=torch.int32)[None]}
    out = bucketed_allreduce(tree, "data", bucket_bytes=128, size=1)
    for k in tree:
        assert torch.equal(out[k], tree[k])
    with pytest.raises(ValueError, match="size="):
        bucketed_allreduce(tree, "data", bucket_bytes=128)


def test_compression_bf16_within_4e_3():
    from repro_torch.comm import compressed_allreduce
    g = {"w": torch.linspace(-1, 1, 1000)[None]}
    out, st = compressed_allreduce(g, "data", scheme="bf16", mean=True,
                                   size=1)
    assert st is None
    np.testing.assert_allclose(out["w"].numpy(), g["w"].numpy(), atol=4e-3)


def test_error_feedback_shrinks_the_accumulated_bias():
    """With error feedback the mean of 20 compressed steps matches the
    true gradient far below bf16's eps; without it the bias stays."""
    from repro_torch.comm import CompressionState, compressed_allreduce
    g = {"w": torch.linspace(-1, 1, 1000)[None]}
    acc = {True: torch.zeros_like(g["w"]), False: torch.zeros_like(g["w"])}
    for ef in (True, False):
        st = CompressionState.init(g, enabled=ef)
        for _ in range(20):
            out, st = compressed_allreduce(g, "data", scheme="bf16",
                                           state=st, mean=True, size=1)
            acc[ef] += out["w"]
    err = {ef: float((a / 20 - g["w"]).abs().max()) for ef, a in acc.items()}
    assert err[True] < 1e-4 < err[False], err


# ----------------------------------------------------------------------
# (5) trajectories against the reference
# ----------------------------------------------------------------------
def _assert_params(got_tree, ref, run, atol=2e-5):
    prefix = f"run:{_key(run)}:param:"
    n_small = n_all = 0
    for key in sorted(k for k in ref if k.startswith(prefix)):
        path = key[len(prefix):].split("/")
        node = got_tree
        for p in path:
            node = node[p]
        got, want = node.numpy(), ref[key]
        rmin = ref[f"run:{_key(run)}:rmin:" + key[len(prefix):]]
        small = rmin < 1e-4
        n_small += int(small.sum())
        n_all += small.size
        np.testing.assert_allclose(got[~small], want[~small], rtol=2e-4,
                                   atol=atol, err_msg=key)
        assert np.all(np.abs(got - want)[small] <= 0.1 * LR), key
    assert n_all and n_small < 0.4 * n_all     # 12-34% here


def _ref_case(case: str) -> str:
    """The reference run a port case is held to: overlapped runs to the
    blocking ones (the reference's own bit-identity)."""
    return {"overlap_leaf": "leaf", "overlap_bucket": "bucket"}.get(case,
                                                                    case)


# every reference run's case (and the overlapped twin of a blocking one)
# under the port backends held to it
PORT_RUNS = tuple((arch, dp, c, backend)
                  for arch, dp, case, twin in RUNS
                  for c in ((case, "overlap_" + case)
                            if case in ("leaf", "bucket") else (case,))
                  for backend in (("xla",) if twin == "xla"
                                  else ("posh", "pallas")))


@pytest.mark.parametrize("run", PORT_RUNS, ids=_key)
def test_dp_trajectory_matches_the_reference(ref, port, run):
    arch, dp, case, backend = run
    twin = (arch, dp, _ref_case(case), _twin(backend))
    metrics, tree = port(arch, dp, case, backend)
    want = ref[f"run:{_key(twin)}:metrics"]
    np.testing.assert_allclose(metrics[:, 0], want[:, 0], rtol=1e-5)
    # bf16 on the wire: a gradient 1e-7 off the reference's may round to
    # the next bf16 (2^-8 apart), which moves the norm by up to ~1e-4
    np.testing.assert_allclose(metrics[:, 1], want[:, 1],
                               rtol=1e-4 if case == "bf16" else 1e-5)
    # bf16: such a rounding moves Adam's normalized step by ~2^-8 (of
    # lr = 5e-3: 2e-5) a step, for up to 3 steps
    _assert_params(tree["params"], ref, twin,
                   atol=0.01 * LR if case == "bf16" else 2e-5)


# ----------------------------------------------------------------------
# (6) bit-identities in the port
# ----------------------------------------------------------------------
def _same_run(a, b):
    from repro_torch.tree import leaves
    assert np.array_equal(a[0], b[0])
    for x, y in zip(leaves(a[1]), leaves(b[1])):
        assert torch.equal(x, y)


@pytest.mark.parametrize("run", [r for r in PORT_RUNS
                                 if r[2].startswith("overlap")], ids=_key)
def test_overlapped_equals_blocking_bit_for_bit(port, run):
    arch, dp, case, backend = run
    _same_run(port(*run), port(arch, dp, _ref_case(case), backend))


@pytest.mark.parametrize("run", [r for r in PORT_RUNS if r[3] == "pallas"],
                         ids=_key)
def test_pallas_equals_posh_bit_for_bit(port, run):
    _same_run(port(*run), port(*run[:3], "posh"))


@pytest.mark.parametrize("backend", ["xla", "posh", "pallas"])
@pytest.mark.parametrize("how", ["leaf", "bucket", "overlap_leaf",
                                 "overlap_bucket", "bf16", "int8"])
def test_every_reduced_row_equals_row_0(ref, backend, how):
    """One step's replica gradients at dp 8 (smoke qwen3-8b), reduced by
    each schedule: every row of every reduced leaf is row 0's bits (the
    overlapped schedule in the rows' own storage)."""
    from repro_torch import configs
    from repro_torch.data import SyntheticLM
    from repro_torch.models import lm
    from repro_torch.train import grad as tgrad
    from repro_torch.train.step import train_state_from
    from repro_torch.train import AdamWConfig
    from repro_torch.tree import leaves
    from repro_torch.weights import from_jax

    cfg = configs.get_smoke("qwen3-8b")
    ctx = _ctx(8, backend)
    params = train_state_from(from_jax(_params_np(ref, "qwen3-8b")), ctx,
                              AdamWConfig())["params"]
    batch = SyntheticLM(vocab=cfg.vocab, seq_len=cfg.max_seq,
                        global_batch=8).batch(0, device="cpu")
    loss, rows, _ = tgrad.loss_and_grad(lm.loss_fn, params, batch, ctx, cfg)
    assert loss.shape == (8,) and torch.equal(loss, loss[:1].expand(8))
    _, raw = tgrad.replica_grads(lm.loss_fn, params, batch, ctx, cfg)
    kw = {"leaf": {}, "bucket": {"bucket_bytes": BUCKET},
          "overlap_leaf": {"overlap": True},
          "overlap_bucket": {"overlap": True, "bucket_bytes": BUCKET},
          "bf16": {"compress": "bf16"}, "int8": {"compress": "int8"}}[how]
    for a, b in zip(leaves(rows), leaves(raw)):      # replicas differ
        assert not torch.equal(b[0], b[1])
        assert a.shape == b.shape
        assert torch.equal(a, a[:1].expand_as(a))    # loss_and_grad's mean
    with torch.no_grad():
        red, _ = tgrad.combine_grads(raw, None, ctx, **kw)
    for g in leaves(red):
        assert g.shape[0] == 8
        assert torch.equal(g, g[:1].expand_as(g))
    # the overlapped schedule reduces in place: the rows are the result
    assert (red is raw) == how.startswith("overlap")


# ----------------------------------------------------------------------
# (7) DP 2 == dp 1 on the same global batch
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["gemma-2b", "qwen3-8b"])
def test_dp2_equals_dp1_on_the_same_global_batch(port, arch):
    one = port(arch, 1, "leaf", "posh")
    two = port(arch, 2, "leaf", "posh")
    np.testing.assert_allclose(two[0], one[0], rtol=1e-5)


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen3-8b"])
def test_dp2_microbatches_equal_one_batch(port, arch):
    """DP 2 with 2 microbatches a replica == 1 on the same global batch
    (16 rows): the loss within 1e-5, the parameters within 2e-4 / 2e-5,
    ``tests/test_train.py``'s microbatch rule."""
    from repro_torch.tree import leaves
    two = port(arch, 2, "mb2", "posh")
    one = port(arch, 2, "mb2", "posh", microbatches=1)
    np.testing.assert_allclose(two[0][:, 0], one[0][:, 0], rtol=1e-5)
    for a, b in zip(leaves(two[1]["params"]), leaves(one[1]["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-5)


# ----------------------------------------------------------------------
# (8) ZeRO-1 at dp 2
# ----------------------------------------------------------------------
def test_zero1_ignores_the_reduction_flags(port):
    """As the reference's step (its zero-0 guard): under ZeRO-1 the
    bucket, overlap and compress flags change nothing; the grad norm is
    replica 0's own (the clip is replica-local), not the reduced one."""
    base = port("gemma-2b", 2, "zero1", "posh")
    for extra in (dict(bucket_bytes=BUCKET), dict(overlap_grad_sync=True),
                  dict(compress="bf16")):
        _same_run(port("gemma-2b", 2, "zero1", "posh", **extra), base)
    zero0 = port("gemma-2b", 2, "leaf", "posh")
    assert base[0][0, 0] == zero0[0][0, 0]
    assert abs(base[0][0, 1] - zero0[0][0, 1]) > 1e-3 * zero0[0][0, 1]


def test_zero1_pads_and_keeps_the_tail_zero(ref):
    """Leaves of 7 and 15 elements at dp 2: chunks of 4 and 8, one pad
    each, held at 0 in m, v and master; the params, m, v and master the
    reference's (its global views ``(dp * c,)``)."""
    from repro_torch.train import AdamWConfig, adamw_init, adamw_update

    ctx = _ctx(2, "posh")
    opt = AdamWConfig(lr=LR, zero=1)
    params = {k: torch.from_numpy(v.copy()) for k, v in _pad_params().items()}
    st = adamw_init(params, ctx, opt)
    assert st["m"]["w"].shape == (2, 4) and st["m"]["u"].shape == (2, 8)
    for g in _pad_grads():
        adamw_update(params, {k: torch.from_numpy(v) for k, v in g.items()},
                     st, ctx, opt)
    for name, tree in (("param", params), ("m", st["m"]), ("v", st["v"]),
                       ("master", st["master"])):
        for k, n in (("w", 7), ("u", 15)):
            got = tree[k].reshape(-1).numpy()
            np.testing.assert_allclose(got, ref[f"pad:{name}:{k}"].reshape(
                -1), rtol=1e-6, atol=1e-7, err_msg=f"{name}:{k}")
            if name != "param":
                assert np.all(got[n:] == 0), (name, k)


# ----------------------------------------------------------------------
# (9) the DP 2 ZeRO-1 state and checkpoint across the packages
# ----------------------------------------------------------------------
def test_zero1_state_tree_is_the_references(ref, port):
    """``state_to_tree`` of the port's DP 2 ZeRO-1 state after 3 steps:
    the reference's leaves in its order, shapes and dtypes (ZeRO-1 chunks
    as the ``(dp * c,)`` global view); count and step; m and sqrt(v) (a
    sum of clipped gradients, and their rms) within rtol 1e-4 and 1e-3
    of the leaf's largest magnitude (at step 3 the gradients move with
    the parameters' drift of steps 1 and 2: measured up to 1.4e-4 of
    the leaf's scale), master within 2e-4 / 0.1 x lr (the trajectory
    rule's bound); the params are the trajectory test's."""
    from repro_torch.tree import leaves

    arch, dp, case, backend = CKPT_RUN
    _, tree = port(arch, dp, case, backend)
    got = leaves(tree)
    n = len([k for k in ref if k.startswith("state:")])
    assert len(got) == n
    n_p = len(leaves(tree["params"]))
    n_opt = len(leaves(tree["opt"]["m"]))
    assert n == 1 + 3 * n_opt + n_p + 1
    for i, g in enumerate(got):
        want = ref[f"state:{i}"]
        assert tuple(g.shape) == want.shape and \
            str(g.dtype).split(".")[1] == str(want.dtype), i
    assert int(tree["opt"]["count"]) == STEPS == int(tree["step"])
    for j, key in enumerate(("m", "master", "v")):     # leaves order
        for i in range(n_opt):
            idx = 1 + j * n_opt + i
            g, want = got[idx].numpy(), ref[f"state:{idx}"]
            if key == "v":                   # held as its rms, a gradient
                g, want = np.sqrt(g), np.sqrt(want)
            scale = 1e-3 * np.abs(want).max()
            tol = {"m": (1e-4, scale), "v": (1e-4, scale),
                   "master": (2e-4, 0.1 * LR)}[key]
            np.testing.assert_allclose(g, want, rtol=tol[0], atol=tol[1],
                                       err_msg=f"{key}[{i}]")


def test_jax_dp2_checkpoint_resumes_in_the_port(ref):
    """The reference's DP 2 ZeRO-1 gemma-2b smoke state after one step,
    written by ``repro.ckpt.Checkpointer``: the port's DP 2 ZeRO-1
    trainer restores it and takes steps 1 and 2 with the reference's
    losses and grad norms (rtol 1e-5)."""
    from repro_torch.ckpt import Checkpointer
    from repro_torch.launch.train import build_trainer

    arch, dp, case, backend = CKPT_RUN
    tr = build_trainer(arch, smoke=True, device="cpu", lr=LR, seed=5,
                       dp_size=dp, zero=1, backend=backend)
    assert tr.restore(Checkpointer(ref["ckpt_dir"])) == 1
    assert tr.state["opt"]["m"]["embed"]["table"].shape[0] == dp
    got = [(m["loss"], m["grad_norm"]) for m in (tr.step(1), tr.step(2))]
    np.testing.assert_allclose(np.array(got),
                               ref[f"run:{_key(CKPT_RUN)}:metrics"][1:],
                               rtol=1e-5)


if __name__ == "__main__" and "--jax-worker" in sys.argv:
    i = sys.argv.index("--jax-worker")
    _jax_worker(sys.argv[i + 1], int(sys.argv[i + 2]), int(sys.argv[i + 3]))
