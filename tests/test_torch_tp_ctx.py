"""Tensor-parallel training and decode in the ctx attention layout (the
heads do not divide tp: every PE keeps every head for its own token
shard, K/V all-gathered, each PE's queries at its own causal offset)
against the JAX reference's mesh and the port at tp = 1, on the CPU.

The reference runs under ``smap`` on a mesh of CPU devices, which must
be set before JAX starts; so this file re-executes itself in a
subprocess (``--jax-worker``) with 8 fake CPU devices, as
``test_torch_tp_train.py`` does, compiles its programs on a thread pool
and caches the run in a module fixture.  The port runs the same
weights and batches with the kernels' plain versions.

Held to the reference and to the port at tp = 1:

  (1) ``tests/multipe/run_tp_equiv``'s minitron-4b cases, xla and posh,
      at DP 2 x TP 4 with ``sp`` and remat (the smoke config's 6 heads
      take the ctx layout at tp 4): the loss within rtol 2e-5, every
      leaf's global gradient (``weights.unshard`` of the stacked rows)
      within 5e-4 of its largest, that suite's tolerances;
  (2) whisper-base at a (1, 8) mesh (4 heads at tp 8: the ctx layout,
      its self and cross attention; the encoder with ``sp`` off), the
      same tolerances;
  (3) a 3-step minitron trajectory at DP 2 x TP 4 (xla): the loss shown
      within rtol 1e-5, the grad norm within 1e-4, every PE's copy of
      each replicated attention weight equal (its gradient the sum of
      the PEs' partials), and every PE's parameters within 1e-2 of that
      reference device's own movement, leaf by leaf (2-norm: PR 25's
      rule; measured 1.1e-3 at worst).  Element by element the three
      Adam steps amplify the last bits of the psums, summed in another
      order: 0.03-0.09% of a leaf's elements leave
      ``test_torch_tp_train``'s bound (rtol 2e-4 / atol 2e-5) by up to
      7e-5, and the reference's own -O0 and -O3 builds part by as much
      (2e-5 of the step-3 norm, up to 1e-4 in the embedding);
  (4) the contiguous-cache decode at TP 4 on a (1, 4) mesh: qwen3-8b
      (head layout, its 2 KV heads replicated at tp 4) and minitron-4b
      (ctx layout, the cache sequence-sharded, 8 rows a PE at max_len
      32): greedy streams token for token and the final state per PE
      (``test_torch_decode``'s rules).  The reference's ctx decode caps
      the readable length at the per-PE row count (``cur = min(pos + 1,
      rows)``), so from position 8 on it attends PE 0's rows only: the
      port, which reads every row below ``pos + 1``, is held to it
      through position 7 and to its own tp = 1 stream throughout, and
      the reference's TP 4 stream is shown to leave its own tp = 1
      stream there (ROADMAP §C);
  (5) the flash attention's per-PE query offset (``pe_rows`` /
      ``pe_stride``): the plain forward and its FA-2 backward over the
      folded batch equal a loop of single-PE calls at each offset
      exactly, and the reference's ``blocked_attention(q_offset=)`` per
      PE within 1e-6 of the largest output / gradient.
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

from test_torch_tp_train import _key, _per_pe, _tree, _worst

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.abspath(__file__))
LR = 5e-3
STEPS = 3
BATCH = 8
# (arch, backend, dp, tp, ce_mode) of the equivalence runs
EQUIV = (("minitron-4b", "xla", 2, 4, "vocab_parallel"),
         ("minitron-4b", "posh", 2, 4, "vocab_parallel"),
         ("whisper-base", "xla", 1, 8, "vocab_parallel"))
TRAJ = ("minitron-4b", 2, 4, 0, 1.0)            # arch, dp, tp, zero, clip
# decode: (arch, tp, the steps held to the reference); the ctx layout's
# reference is right while pos < ceil(MAX_LEN / tp)
DEC_B, DEC_MAX, DEC_PROMPT, DEC_STEPS = 2, 32, 4, 16
DECODE = (("qwen3-8b", 4, DEC_STEPS), ("minitron-4b", 4, DEC_MAX // 4))
# the vlm's gates, per group, non-zero (both start at zero)
GATES = {"xgate": (0.6, -0.45), "mgate": (-0.3, 0.8)}
# (tp, b, rows a PE, H, H_kv, dh) of the per-PE flash case
FLASH = (4, 2, 8, 6, 2, 16)
ARCHS = ("minitron-4b", "whisper-base", "qwen3-8b")
ATTN = tuple(f"blocks/attn/{w}" for w in ("wk", "wo", "wq", "wv"))


def _f32(jnp):
    return dict(param_dtype=jnp.float32, compute_dtype=jnp.float32)


# ======================================================================
# the JAX side (a subprocess with 8 CPU devices); the families file
# drives its runs through these too
# ======================================================================
def ref_models(archs, out):
    """Each arch's weights and batch of 4 rows, written to ``out`` for the
    port: the weights drawn by the port's ``init`` (the reference's
    distributions and constants, seed 0; drawing them in JAX op by op
    costs the worker 5-12 CPU s an arch) with the vlm's gates set, the
    batch from numpy (seed 1)."""
    import jax
    import jax.numpy as jnp

    from repro import configs
    from repro.models import registry
    from repro_torch import configs as tconfigs
    from repro_torch.models import registry as tregistry
    from repro_torch.tree import tree_map

    models = {}
    for arch in archs:
        cfg = configs.get_smoke(arch)
        tcfg = tconfigs.get_smoke(arch)
        drawn = tregistry.build(tcfg).init(torch.Generator().manual_seed(0),
                                           tcfg)
        if cfg.family == "vlm":
            for k, v in GATES.items():
                drawn["cross"][k] = torch.tensor(v)[:, None]
        params = tree_map(lambda t: jnp.asarray(t.numpy()), drawn)
        rng = np.random.RandomState(1)
        batch = {"tokens": rng.randint(0, cfg.vocab, (4, cfg.max_seq + 1))
                 .astype(np.int32)}
        if cfg.family == "vlm":
            batch["img_embeds"] = 0.1 * rng.randn(
                4, cfg.img_tokens, cfg.d_model).astype(np.float32)
        if cfg.family == "encdec":
            batch["frames"] = 0.1 * rng.randn(
                4, cfg.enc_frames, cfg.d_model).astype(np.float32)
        models[arch] = (cfg, registry.build(cfg), params,
                        {k: jnp.asarray(v) for k, v in batch.items()})
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            out[f"params0:{arch}:" + "/".join(str(k.key) for k in path)] = \
                np.asarray(leaf)
        for k, v in batch.items():
            out[f"batch:{arch}:{k}"] = v
    return models


def _bspecs(batch):
    from jax.sharding import PartitionSpec as P
    return {k: P("data") if k == "tokens" else P("data", None, None)
            for k in batch}


def ref_equiv(models, arch, backend, dp, tp, ce):
    """``run_tp_equiv.check``'s DP x TP loss and gradients."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro import compat
    from repro.parallel.ctx import ParallelCtx, smap
    from repro.train.grad import loss_and_grad

    cfg, api, params, batch = models[arch]
    mesh = compat.make_mesh((dp, tp), ("data", "model"),
                            devices=jax.devices()[:dp * tp])
    ctx = ParallelCtx(dp_size=dp, tp_size=tp, sp=True, remat=True,
                      backend=backend, ce_mode=ce, **_f32(jnp))

    def fn(p, bt):
        l, g, _ = loss_and_grad(api.loss_fn, p, bt, ctx, cfg,
                                api.specs(cfg, ctx))
        return l, g
    specs = api.specs(cfg, ctx)
    loss, grads = jax.jit(smap(fn, mesh, (specs, _bspecs(batch)),
                               (P(), specs)))(params, batch)
    pre = _key("equiv", arch, backend, dp, tp, ce, "")
    res = {pre + "loss": np.asarray(loss)}
    for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]:
        res[pre + "grad:" + "/".join(str(k.key) for k in path)] = \
            np.asarray(leaf)
    return res


def _per_device(a, mesh, shape):
    """Every device's own buffer of ``a``, (*mesh shape, *local)."""
    where = {d: idx for idx, d in np.ndenumerate(mesh.devices)}
    res = None
    for sh in a.addressable_shards:
        data = np.asarray(sh.data)
        if res is None:
            res = np.empty(tuple(shape) + data.shape, data.dtype)
        res[where[sh.device]] = data
    return res


def ref_decode(models, arch, tp, hold):
    """The reference's ``decode_step`` under ``smap`` on a (1, tp) mesh:
    the prompt fed, then greedy, DEC_STEPS steps; the stream and every
    device's state after ``hold`` steps (the state specs replicated, so
    each device keeps its own buffers).  The vlm's image K/V and
    whisper's encoder K/V are made per device under the same mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro import compat
    from repro.models import attention as attn
    from repro.models import encdec
    from repro.parallel.ctx import ParallelCtx, smap

    cfg, api, params, batch = models[arch]
    mesh = compat.make_mesh((1, tp), ("data", "model"),
                            devices=jax.devices()[:tp])
    ctx = ParallelCtx(dp_size=1, tp_size=tp, sp=False, remat=False,
                      **_f32(jnp))
    specs = api.specs(cfg, ctx)
    rep = lambda a: P(*([None] * a.ndim))               # noqa: E731
    state = api.init_decode_state(cfg, ctx, DEC_B, DEC_MAX)
    sspecs = jax.tree.map(rep, state)
    state = jax.device_put(state, jax.tree.map(
        lambda s: NamedSharding(mesh, s), sspecs))
    extra, especs = (), ()
    if cfg.family in ("vlm", "encdec"):
        src = batch["img_embeds" if cfg.family == "vlm" else "frames"]

        def kv_fn(p, x):
            if cfg.family == "encdec":
                return encdec.encoder_cross_kv(
                    p, encdec.encode(p, x, ctx, cfg), ctx, cfg)
            kvs = [attn.cross_kv(jax.tree.map(lambda a: a[g],
                                              p["cross"])["xattn"], x, ctx,
                                 cfg)
                   for g in range(cfg.n_layers // cfg.cross_attn_every)]
            return (jnp.stack([k for k, _ in kvs]),
                    jnp.stack([v for _, v in kvs]))
        kv_specs = (P(*([None] * 5)), P(*([None] * 5)))
        extra = (jax.jit(smap(kv_fn, mesh, (specs, P()), kv_specs))(
            params, src[:DEC_B]),)
        especs = (kv_specs,)

    def step(p, tok, st, *ex):
        if cfg.family == "encdec":
            return api.decode_step(p, tok, st, ex[0], ctx, cfg)
        if cfg.family == "vlm":
            return api.decode_step(p, tok, st, ctx, cfg, img_kv=ex[0])
        return api.decode_step(p, tok, st, ctx, cfg)
    fn = jax.jit(smap(step, mesh, (specs, P(None), sspecs) + especs,
                      (P(None), sspecs)))
    prompt = np.random.RandomState(5).randint(
        0, cfg.vocab, (DEC_B, DEC_PROMPT)).astype(np.int32)
    pre = _key("decode", arch, tp, "")
    res, toks, tok = {pre + "prompt": prompt}, [], None
    for i in range(DEC_STEPS):
        tin = jnp.asarray(prompt[:, i]) if i < DEC_PROMPT else tok
        tok, state = fn(params, tin, state, *extra)
        toks.append(np.asarray(tok))
        if i + 1 == hold:
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                    state)[0]:
                key = "/".join(str(getattr(k, "key", k)) for k in path)
                res[pre + "state:" + key] = _per_device(
                    leaf, mesh, (1, tp))[0].astype(np.float32)
    res[pre + "stream"] = np.stack(toks)
    return res


def _flash_inputs():
    tp, b, tl, h, hkv, dh = FLASH
    rng = np.random.RandomState(11)
    q = rng.randn(tp * b, tl, h, dh).astype(np.float32)
    k = rng.randn(b, tp * tl, hkv, dh).astype(np.float32)
    v = rng.randn(b, tp * tl, hkv, dh).astype(np.float32)
    ct = rng.randn(tp * b, tl, h, dh).astype(np.float32)
    return q, k, v, ct


def _ref_flash():
    """The reference's ``blocked_attention(q_offset=r * rows)`` for each
    PE r's rows, output and the gradients of ``<out, ct>``, causal and
    with a window of 5: the PEs vmapped over a traced offset (the full KV
    range, masked), one jitted program."""
    import jax
    import jax.numpy as jnp

    from repro.models.flash import blocked_attention

    tp, b, tl = FLASH[:3]
    q, k, v, ct = (a.reshape((tp, b) + a.shape[1:]) if i in (0, 3) else a
                   for i, a in enumerate(_flash_inputs()))

    def one(q_, ct_, off, win):
        def f(q_, k_, v_):
            o = blocked_attention(q_, k_, v_, causal=True, window=win,
                                  q_offset=off, block_q=4, block_kv=8)
            return jnp.sum(o * ct_), o
        (_, o), g = jax.value_and_grad(f, argnums=(0, 1, 2),
                                       has_aux=True)(q_, k, v)
        return (o,) + tuple(g)

    def all_pes(q, ct):
        offs = jnp.arange(tp) * tl
        return [jax.vmap(lambda a, c, o: one(a, c, o, win))(q, ct, offs)
                for win in (None, 5)]
    res = {}
    for win, vals in zip((None, 5), jax.jit(all_pes)(q, ct)):
        for r in range(tp):
            for name, a in zip(("out", "dq", "dk", "dv"), vals):
                res[_key("flash", win, r, name)] = np.asarray(a[r])
    return res


def ref_trajectory(models, arch, dp, tp, zero, clip):
    """``STEPS`` train steps at DP x TP: the metrics, replica 0's PEs'
    parameters, and the smallest Adam rms each device saw."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro import compat
    from repro.data import SyntheticLM
    from repro.parallel.ctx import ParallelCtx, smap
    from repro.train.optimizer import AdamWConfig, adamw_init
    from repro.train.step import make_train_step, train_state_specs

    cfg, api, params, _ = models[arch]
    mesh = compat.make_mesh((dp, tp), ("data", "model"),
                            devices=jax.devices()[:dp * tp])
    ctx = ParallelCtx(dp_size=dp, tp_size=tp, sp=True, remat=True,
                      backend="xla", **_f32(jnp))
    opt = AdamWConfig(lr=LR, zero=zero)
    sspecs = train_state_specs(cfg, ctx, api, opt)
    init = jax.jit(smap(lambda p: adamw_init(p, ctx, opt), mesh,
                        (api.specs(cfg, ctx),), sspecs["opt"]))
    state = jax.device_put(
        {"params": params, "opt": init(params),
         "step": jnp.zeros((), jnp.int32)},
        jax.tree.map(lambda sp: NamedSharding(mesh, sp), sspecs,
                     is_leaf=lambda x: isinstance(x, P)))
    fn = jax.jit(smap(make_train_step(cfg, ctx, api, opt, clip_norm=clip),
                      mesh, (sspecs, {"tokens": P("data")}),
                      (sspecs, {"loss": P(), "grad_norm": P(),
                                "step": P()})))
    data = SyntheticLM(vocab=cfg.vocab, seq_len=cfg.max_seq,
                       global_batch=BATCH)
    metrics, rmin = [], None
    for s in range(STEPS):
        state, m = fn(state, data.batch(s))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        bc2 = 1 - opt.b2 ** (s + 1)
        rms = jax.tree.map(lambda v: np.sqrt(
            _per_device(v, mesh, (dp, tp))[0] / bc2), state["opt"]["v"])
        rms = jax.tree.map(lambda r: np.where(r > 0, r, np.inf), rms)
        rmin = rms if rmin is None else jax.tree.map(np.minimum, rmin, rms)
    pre = _key("traj", arch, dp, tp, zero, clip, "")
    res = {pre + "metrics": np.array(metrics)}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            state["params"])[0]:
        key = "/".join(str(k.key) for k in path)
        dev = _per_device(leaf, mesh, (dp, tp))
        res[pre + "param:" + key] = dev[0]
        res[pre + "dp_same:" + key] = np.array(np.array_equal(dev[0],
                                                              dev[-1]))
    for path, leaf in jax.tree_util.tree_flatten_with_path(rmin)[0]:
        res[pre + "rmin:" + "/".join(str(k.key) for k in path)] = leaf
    return res


def run_worker(out_path, archs, jobs) -> None:
    """Build the models, run ``jobs`` (callables of the models) on a
    thread pool, and save everything with the CPU seconds spent."""
    t_start = time.monotonic()
    out = {}
    models = ref_models(archs, out)
    with ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(job, models) for job in jobs]:
            out.update(f.result())
    use = resource.getrusage(resource.RUSAGE_SELF)
    out["seconds"] = np.array(time.monotonic() - t_start)
    out["cpu_seconds"] = np.array(use.ru_utime + use.ru_stime)
    np.savez(out_path, **out)


def _jax_worker(out_path: str) -> None:
    jobs = [lambda m, c=c: ref_equiv(m, *c) for c in EQUIV]
    jobs += [lambda m: ref_trajectory(m, *TRAJ)]
    jobs += [lambda m, c=c: ref_decode(m, *c) for c in DECODE]
    jobs += [lambda m: ref_decode(m, "minitron-4b", 1, DEC_STEPS),
             lambda m: _ref_flash()]
    run_worker(out_path, ARCHS, jobs)


def spawn_worker(test_file: str, tmp_path_factory, name: str,
                 xla_flags: str = "") -> dict:
    """Run ``test_file``'s JAX worker in a subprocess with 8 CPU devices
    (and ``xla_flags``); its results."""
    path = tmp_path_factory.mktemp(name) / "ref.npz"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
               + xla_flags,
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(os.path.dirname(
                   ROOT), "src"), ROOT]))
    r = subprocess.run([sys.executable, os.path.abspath(test_file),
                        "--jax-worker", str(path)], env=env,
                       cwd=os.path.dirname(ROOT), capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# ======================================================================
# the port's side
# ======================================================================
@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return spawn_worker(__file__, tmp_path_factory, "jax_tp_ctx")


def ctx_of(dp=1, tp=1, backend="xla", ce="vocab_parallel", remat=True):
    from repro_torch.parallel import ParallelCtx
    return ParallelCtx(dp_size=dp, tp_size=tp, backend=backend,
                       ce_mode=ce, remat=remat,
                       param_dtype=torch.float32, compute_dtype=torch.float32)


def port_params(ref, arch):
    from repro_torch.weights import from_jax
    return from_jax(_tree(ref, f"params0:{arch}:"))


def port_batch(ref, arch):
    pre = f"batch:{arch}:"
    return {k[len(pre):]: torch.from_numpy(np.array(v))
            for k, v in ref.items() if k.startswith(pre)}


def port_loss_grads(ref, arch, ctx):
    """The port's ``loss_and_grad`` on the reference's batch: (the loss
    shown, replica 0's global gradients as numpy)."""
    from repro_torch import configs
    from repro_torch.models import lm, registry
    from repro_torch.train import grad as tgrad
    from repro_torch.tree import tree_map
    from repro_torch.weights import shard_for_tp, unshard

    cfg = configs.get_smoke(arch)
    params = shard_for_tp(port_params(ref, arch), cfg, ctx.tp_size)
    params = tgrad.trainable(lm.unstack(params))
    loss, grads, _ = tgrad.loss_and_grad(registry.build(cfg).loss_fn, params,
                                         port_batch(ref, arch), ctx, cfg)
    g0 = tree_map(lambda g: g[0], grads)
    if ctx.tp_size > 1:
        g0 = unshard(g0, cfg, ctx.tp_size)
    return loss, tree_map(lambda g: g.numpy(), g0)


def hold_equiv(ref, port1, case):
    """(1)/(2): the port's DP x TP run against the reference's and the
    port's tp = 1 (``port1``: arch -> loss, grads)."""
    arch, backend, dp, tp, ce = case
    loss, grads = port_loss_grads(ref, arch, ctx_of(dp, tp, backend, ce))
    assert loss.shape == (dp, tp)
    assert torch.all(loss == loss[0, 0])
    pre = _key("equiv", arch, backend, dp, tp, ce, "")
    l1, g1 = port1
    np.testing.assert_allclose(float(loss[0, 0]), float(ref[pre + "loss"]),
                               rtol=2e-5)
    np.testing.assert_allclose(float(loss[0, 0]), float(l1[0]), rtol=2e-5)
    from repro_torch.tree import tree_map
    torch_grads = tree_map(torch.from_numpy, grads)
    assert _worst(torch_grads, _tree(ref, pre + "grad:")) < 5e-4
    assert _worst(torch_grads, g1) < 5e-4


@pytest.fixture(scope="module")
def port1(ref):
    return {arch: port_loss_grads(ref, arch, ctx_of())
            for arch in ("minitron-4b", "whisper-base")}


@pytest.mark.parametrize("case", EQUIV, ids=lambda c: f"{c[0]}-{c[1]}-"
                         f"dp{c[2]}xtp{c[3]}")
def test_ctx_layout_matches_tp1_and_the_reference(ref, port1, case):
    """(1), (2): loss rtol 2e-5, gradients 5e-4 of each leaf's largest."""
    from repro_torch import configs
    assert configs.get_smoke(case[0]).attn_layout(case[3]) == "ctx"
    hold_equiv(ref, port1[case[0]], case)


def test_ctx_layout_trajectory_matches_per_pe(ref):
    """(3): 3 steps at DP 2 x TP 4, every PE's parameters."""
    from repro_torch import configs
    from repro_torch.data import SyntheticLM
    from repro_torch.models import registry
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.step import train_state_from

    arch, dp, tp, zero, clip = TRAJ
    cfg = configs.get_smoke(arch)
    ctx = ctx_of(dp, tp)
    opt = AdamWConfig(lr=LR, zero=zero)
    state = train_state_from(port_params(ref, arch), ctx, opt, cfg)
    step = make_train_step(cfg, ctx, registry.build(cfg), opt,
                           clip_norm=clip)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=cfg.max_seq,
                       global_batch=BATCH)
    metrics = []
    for s in range(STEPS):
        state, m = step(state, data.batch(s, device="cpu"))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    pre = _key("traj", *TRAJ, "")
    got, want = np.array(metrics), ref[pre + "metrics"]
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-5)
    # a later step's norm reads the parameters Adam moved by ~lr where a
    # PE's denominator was tiny (the rule's exemption below): step 3's
    # parts by 4.7e-5 of itself here, the reference's own -O0 and -O3
    # builds' by 2e-5
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-4)
    # every attention leaf is replicated in the ctx layout: each PE
    # holds all of it, its gradient the sum of the PEs' partials over
    # their token shards, so every copy takes the same step
    for key in ATTN:
        got = _per_pe(state, key, tp)
        assert got.shape[0] == tp, key
        assert all(np.array_equal(got[r], got[0]) for r in range(tp)), key
    worst = hold_moved(ref, pre, state, tp, arch)
    print(f"worst per-leaf part of the reference's movement: "
          f"{max(worst.values()):.2e} ({max(worst, key=worst.get)})")


def hold_moved(ref, pre, state, tp, arch, rel=1e-2) -> dict:
    """PR 25's per-leaf trajectory rule, PE by PE: each leaf of each PE
    within ``rel`` of the reference device's own movement from the
    initial weights (2-norm); returns the worst ratio per leaf."""
    from repro_torch import configs
    from repro_torch.models.registry import tp_specs
    from repro_torch.weights import map_tp, shard_leaf

    cfg = configs.get_smoke(arch)
    p0 = map_tp(lambda w, a, blk: shard_leaf(torch.from_numpy(w), a, blk,
                                             tp).numpy(),
                _tree(ref, f"params0:{arch}:"), tp_specs(cfg, tp))
    worst = {}
    for key in [k[len(pre + "param:"):] for k in ref
                if k.startswith(pre + "param:")]:
        want = ref[pre + "param:" + key]              # (tp, *local)
        assert bool(ref[pre + "dp_same:" + key]), key
        got = _per_pe(state, key, tp)
        start = _leaf_np(p0, key)
        if key.startswith("blocks/"):
            start = np.moveaxis(start, 1, 0)          # (tp, L, ...)
        assert got.shape == want.shape == start.shape, key
        ratios = [np.linalg.norm(got[r] - want[r])
                  / np.linalg.norm(want[r] - start[r]) for r in range(tp)]
        worst[key] = max(ratios)
        assert worst[key] <= rel, (key, ratios)
    return worst


def _leaf_np(tree, key):
    for k in key.split("/"):
        tree = tree[k]
    return tree


def port_decode(ref, arch, tp, steps=DEC_STEPS):
    """The port's decode of the reference's prompt at ``tp``: (the stream
    (steps, b), the state after every step)."""
    from repro_torch import configs
    from repro_torch.models import encdec, lm, registry
    from repro_torch.models.attention import cross_kv
    from repro_torch.weights import shard_for_tp

    cfg = configs.get_smoke(arch)
    api = registry.build(cfg)
    ctx = ctx_of(tp=tp, remat=False)
    params = shard_for_tp(port_params(ref, arch), cfg, tp)
    batch = port_batch(ref, arch)
    prompt = torch.from_numpy(ref[_key("decode", arch, 4, "prompt")])
    state = api.init_decode_state(cfg, ctx, DEC_B, DEC_MAX, device="cpu")
    extra = ()
    with torch.no_grad():
        if cfg.family == "encdec":
            enc = encdec.encode(params, batch["frames"][:DEC_B], ctx, cfg)
            extra = (encdec.encoder_cross_kv(params, enc, ctx, cfg),)
        if cfg.family == "vlm":
            img = lm.per_pe(batch["img_embeds"][:DEC_B], ctx)
            kvs = [cross_kv(lm.layer(params["cross"], g)["xattn"], img, ctx,
                            cfg)
                   for g in range(cfg.n_layers // cfg.cross_attn_every)]
            extra = ((torch.stack([k for k, _ in kvs]),
                      torch.stack([v for _, v in kvs])),)
        toks, states, tok = [], [], None
        for i in range(steps):
            tin = prompt[:, i] if i < DEC_PROMPT else tok
            if cfg.family == "encdec":
                tok, state = api.decode_step(params, tin, state, *extra, ctx,
                                             cfg)
            else:
                tok, state = api.decode_step(params, tin, state, ctx, cfg,
                                             *extra)
            if tp > 1:
                assert torch.equal(tok, tok[:1].expand_as(tok))
                tok = tok[0]
            toks.append(tok.clone())
            states.append({k: (v if isinstance(v, int) else
                               {kk: vv.clone() for kk, vv in v.items()})
                           for k, v in state.items()})
    return torch.stack(toks).numpy(), states


BF16_ULP = 2.0 ** -8
# the hybrid's Mamba states read bf16 conv buffers (test_torch_decode)
MAMBA_STATE = 2.0 ** -6


def hold_state(ref, arch, tp, hold, states):
    """The port's state after ``hold`` steps, per PE, against the
    reference device's (``test_torch_decode``'s rule: f32 within 1e-5 of
    the largest, bf16 within one bf16 ulp, the hybrid's Mamba states
    2^-6)."""
    from repro_torch import configs

    cfg = configs.get_smoke(arch)
    pre = _key("decode", arch, tp, "state:")
    got = states[hold - 1]
    keys = [k[len(pre):] for k in ref if k.startswith(pre)]
    assert keys
    for key in keys:
        want = ref[pre + key]                     # (tp, *device leaf)
        if key == "pos":
            assert set(want.reshape(-1).tolist()) == {hold} == \
                {got["pos"]}
            continue
        group, name = key.split("/")
        node = got[group][name]
        g = node if group == "shared_cache" else node.movedim(1, 0)
        g = g.float().numpy()
        assert g.shape == want.shape, (key, g.shape, want.shape)
        want = want.astype(np.float32)
        scale = float(np.abs(want).max()) or 1.0
        tol = BF16_ULP if node.dtype == torch.bfloat16 else 1e-5
        if cfg.family == "hybrid" and group == "cache":
            tol = MAMBA_STATE
        np.testing.assert_allclose(g, want, rtol=tol, atol=tol * scale,
                                   err_msg=key)
    return keys


@pytest.fixture(scope="module")
def decodes1(ref):
    """The port's tp = 1 streams, once per decode arch."""
    return {arch: port_decode(ref, arch, 1)[0] for arch, _, _ in DECODE}


@pytest.mark.parametrize("arch,tp,hold", DECODE)
def test_tp4_decode_matches_the_reference_and_tp1(ref, decodes1, arch, tp,
                                                  hold):
    """(4): the streams token for token, the state per PE."""
    from repro_torch import configs

    stream, states = port_decode(ref, arch, tp)
    want = ref[_key("decode", arch, tp, "stream")]
    np.testing.assert_array_equal(stream[:hold], want[:hold])
    np.testing.assert_array_equal(stream, decodes1[arch])
    hold_state(ref, arch, tp, hold, states)
    layout = configs.get_smoke(arch).attn_layout(tp)
    assert layout == ("ctx" if arch == "minitron-4b" else "head")
    if layout == "ctx":
        # the reference's own TP 4 stream leaves its tp = 1 stream once
        # positions pass the per-PE rows; the port's does not
        want1 = ref[_key("decode", arch, 1, "stream")]
        np.testing.assert_array_equal(stream, want1)
        assert not np.array_equal(want, want1)
        rows = states[0]["cache"]["k"].shape[3]
        assert rows == -(-DEC_MAX // tp) == hold


def test_per_pe_flash_offsets_equal_single_pe_calls_and_the_reference(ref):
    """(5): the folded batch, ONE call, against a call per PE at its
    offset (exact) and the reference's per-PE ``q_offset`` (1e-6)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.flash import blocked_attention

    tp, b, tl = FLASH[:3]
    q0, k0, v0, ct = (torch.from_numpy(a) for a in _flash_inputs())
    kf, vf = (t.repeat(tp, 1, 1, 1) for t in (k0, v0))  # every PE's copy
    for win in (None, 5):
        q, k, v = (t.clone().requires_grad_(True) for t in (q0, kf, vf))
        o = blocked_attention(q, k, v, causal=True, window=win, block_q=4,
                              block_kv=8, impl="ref", pe_rows=b,
                              pe_stride=tl)
        grads = torch.autograd.grad((o * ct).sum(), (q, k, v))
        out_ref, _ = fa.flash_attention_ref(
            q0.transpose(1, 2), kf.transpose(1, 2), vf.transpose(1, 2),
            causal=True, window=win, pe_rows=b, pe_stride=tl)
        torch.testing.assert_close(out_ref.transpose(1, 2), o.detach(),
                                   rtol=1e-6, atol=1e-6)
        for r in range(tp):
            rows = slice(r * b, (r + 1) * b)
            qr, kr, vr = (t[rows].clone().requires_grad_(True)
                          for t in (q0, kf, vf))
            orr = blocked_attention(qr, kr, vr, causal=True, window=win,
                                    q_offset=r * tl, block_q=4, block_kv=8,
                                    impl="ref")
            gr = torch.autograd.grad((orr * ct[rows]).sum(), (qr, kr, vr))
            assert torch.equal(o[rows].detach(), orr.detach())
            for a, c in zip(grads, gr):
                assert torch.equal(a[rows], c)
            pre = _key("flash", win, r, "")
            for name, got in zip(("out", "dq", "dk", "dv"),
                                 (orr.detach(),) + tuple(gr)):
                want = ref[pre + name]
                err = np.abs(got.numpy() - want).max()
                assert err <= 1e-6 * max(np.abs(want).max(), 1.0), \
                    (win, r, name, err)


def test_reference_worker_within_budget(ref):
    """The JAX worker's CPU seconds (compiles included: 3 loss-and-grad
    programs, one 3-step trajectory, 3 decode programs, the flash
    reference) stay inside the tier-1 budget; its wall seconds are
    reported."""
    print(f"JAX worker: {float(ref['cpu_seconds']):.1f} CPU s, "
          f"{float(ref['seconds']):.1f} s of wall")
    assert float(ref["cpu_seconds"]) < 120


if __name__ == "__main__" and "--jax-worker" in sys.argv:
    _jax_worker(sys.argv[sys.argv.index("--jax-worker") + 1])
