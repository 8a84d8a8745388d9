"""Tensor-parallel training on the stacked team (``ParallelCtx(tp_size=T)``,
sequence parallel, the dense and MoE families in the head layout) against the
JAX reference's 8-PE mesh and the port at tp = 1, on the CPU.

The reference trains under ``smap`` on a (data, model) mesh of CPU
devices, which must be set before JAX starts; so this file re-executes
itself in a subprocess (``--jax-worker``) with
``XLA_FLAGS=--xla_force_host_platform_device_count=8``, as
``test_torch_tp.py`` does, and caches its run in a module fixture.  The
port runs the same weights and batches with the kernels' plain
versions.

Held to the reference:

  (1) the head-layout cases of the reference's TP equivalence suite
      (``tests/multipe/run_tp_equiv``: qwen3-8b under posh, with its KV
      heads replicated at tp 4 (n_kv 2); qwen3-moe-30b-a3b under posh,
      experts split over the ranks, the einsum dispatch; qwen2-moe-a2.7b
      under posh with the alltoall dispatch) and qwen3-8b under xla, at
      DP 2 x TP 4 with ``sp`` and remat: the port's loss within rtol
      2e-5 of the reference's DP2 x TP4 loss and of the port's own tp = 1
      loss, its global gradients (``weights.unshard`` of the stacked
      rows) within 5e-4 of each leaf's largest from both: that suite's
      own tolerances (its psums sum in another order);
  (2) a 3-step DP 2 x TP 4 trajectory of qwen3-moe-30b-a3b (xla, einsum)
      with the clip active on every PE (at 0.5: each PE's local norm is
      0.68-0.89 here, under the default 1.0): the loss
      and the grad norm shown (replica 0's, PE 0's) within rtol 1e-5;
      EVERY PE's parameters held to that reference device's own buffers
      (rtol 2e-4 / atol 2e-5 where the PE's Adam denominator stayed
      above 1e-4, else 0.1 x lr: ``test_torch_train.py``'s rule).  The
      reference clips each device by the norm of its LOCAL leaves (no
      TP reduction, ``repro.train.step``), so its PEs' copies of a
      replicated leaf part after a clipped step; the port's do too,
      PE for PE (ROADMAP §C);
  (3) ZeRO-1 at DP 2 x TP 2 (qwen3-8b, xla), 3 steps: the metrics, every
      PE's parameters as in (2), and the optimizer state in the
      reference's global layout (``state_to_tree``: the chunks in the
      mesh's device order) within the same rule;
  (4) a TP-4 state's tree (``state_to_tree``) has the reference's train
      state's leaves and shapes, loads at tp = 1 (and back at tp = 4)
      exactly, and trains on.

Each JAX program is compiled once, on a thread pool; the worker's CPU
seconds are bounded (``test_reference_worker_within_budget``).
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
BATCH = 8
# (arch, backend, moe_dispatch) of the equivalence runs, DP 2 x TP 4
EQUIV = (("qwen3-8b", "posh", "einsum"), ("qwen3-8b", "xla", "einsum"),
         ("qwen3-moe-30b-a3b", "posh", "einsum"),
         ("qwen2-moe-a2.7b", "posh", "alltoall"))
# arch, dp, tp, zero, clip_norm.  At DP 2 x TP 4 each PE's local grad
# norm is 0.68-0.89 at these weights, so the trajectory clips at 0.5 to
# clip every PE, each by its own norm; ZeRO-1 at TP 2 clips at the
# default 1.0 (norms 1.1-1.4)
TRAJ = ("qwen3-moe-30b-a3b", 2, 4, 0, 0.5)
ZERO1 = ("qwen3-8b", 2, 2, 1, 1.0)
ARCHS = sorted({c[0] for c in EQUIV})


def _key(*parts) -> str:
    return ":".join(str(p) for p in parts)


# ======================================================================
# the JAX worker (a subprocess with 8 CPU devices)
# ======================================================================
def _jax_worker(out_path: str) -> None:
    t_start = time.monotonic()
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro import compat, configs
    from repro.data import SyntheticLM
    from repro.models import registry
    from repro.parallel.ctx import ParallelCtx, smap
    from repro.train.grad import loss_and_grad
    from repro.train.optimizer import AdamWConfig, adamw_init
    from repro.train.step import make_train_step, train_state_specs

    f32 = dict(param_dtype=jnp.float32, compute_dtype=jnp.float32)
    ctx1 = ParallelCtx(dp_size=1, tp_size=1, sp=False, remat=True, **f32)
    out = {}

    def flat(prefix, tree, fn=np.asarray):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = "/".join(str(k.key) for k in path)
            out[prefix + key] = fn(leaf)

    models = {}
    for arch in ARCHS:
        cfg = configs.get_smoke(arch)
        api = registry.build(cfg)
        params = api.init(jax.random.PRNGKey(0), cfg, ctx1)
        tokens = jax.random.randint(jax.random.PRNGKey(1),
                                    (4, cfg.max_seq + 1), 0, cfg.vocab)
        models[arch] = (cfg, api, params, tokens)
        flat(f"params0:{arch}:", params)
        out[f"tokens:{arch}"] = np.asarray(tokens)

    def equiv(arch, backend, disp):
        cfg, api, params, tokens = models[arch]
        mesh = compat.make_mesh((2, 4), ("data", "model"))
        ctx = ParallelCtx(dp_size=2, tp_size=4, sp=True, remat=True,
                          backend=backend, moe_dispatch=disp, **f32)

        def fn(p, bt):
            l, g, _ = loss_and_grad(api.loss_fn, p, bt, ctx, cfg,
                                    api.specs(cfg, ctx))
            return l, g
        loss, grads = jax.jit(smap(fn, mesh, (api.specs(cfg, ctx),
                                              {"tokens": P("data")}),
                                   (P(), api.specs(cfg, ctx))))(
            params, {"tokens": tokens})
        res = {_key("equiv", arch, backend, disp, "loss"): np.asarray(loss)}
        for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]:
            key = "/".join(str(k.key) for k in path)
            res[_key("equiv", arch, backend, disp, "grad") + ":" + key] = \
                np.asarray(leaf)
        return res

    def trajectory(arch, dp, tp, zero, clip):
        cfg, api, params, _ = models[arch]
        devs = np.array(jax.devices()[:dp * tp])
        mesh = compat.make_mesh((dp, tp), ("data", "model"),
                                devices=list(devs))
        ctx = ParallelCtx(dp_size=dp, tp_size=tp, sp=True, remat=True,
                          backend="xla", **f32)
        opt = AdamWConfig(lr=LR, zero=zero)
        sspecs = train_state_specs(cfg, ctx, api, opt)
        init = jax.jit(smap(lambda p: adamw_init(p, ctx, opt), mesh,
                            (api.specs(cfg, ctx),), sspecs["opt"]))
        # placed where the step returns it: no second compile at step 2
        state = jax.device_put(
            {"params": params, "opt": init(params),
             "step": jnp.zeros((), jnp.int32)},
            jax.tree.map(lambda sp: NamedSharding(mesh, sp), sspecs,
                         is_leaf=lambda x: isinstance(x, P)))
        fn = jax.jit(smap(make_train_step(cfg, ctx, api, opt,
                                          clip_norm=clip), mesh,
                          (sspecs, {"tokens": P("data")}),
                          (sspecs, {"loss": P(), "grad_norm": P(),
                                    "step": P()})))
        where = {d: idx for idx, d in np.ndenumerate(mesh.devices)}

        def per_device(a):
            """Every device's own buffer, (dp, tp, *local)."""
            res = None
            for sh in a.addressable_shards:
                data = np.asarray(sh.data)
                if res is None:
                    res = np.empty((dp, tp) + data.shape, data.dtype)
                res[where[sh.device]] = data
            return res

        data = SyntheticLM(vocab=cfg.vocab, seq_len=cfg.max_seq,
                           global_batch=BATCH)
        metrics, rmin = [], None
        for s in range(STEPS):
            state, m = fn(state, data.batch(s))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
            if zero == 0:           # each device's Adam rms of its leaves
                bc2 = 1 - opt.b2 ** (s + 1)
                rms = jax.tree.map(
                    lambda v: np.sqrt(per_device(v)[0] / bc2),
                    state["opt"]["v"])
                rms = jax.tree.map(lambda r: np.where(r > 0, r, np.inf), rms)
                rmin = rms if rmin is None else jax.tree.map(np.minimum,
                                                             rmin, rms)
        pre = _key("traj", arch, dp, tp, zero, clip, "")
        res = {pre + "metrics": np.array(metrics)}
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                state["params"])[0]:
            key = "/".join(str(k.key) for k in path)
            dev = per_device(leaf)
            res[pre + "param:" + key] = dev[0]         # replica 0's PEs
            res[pre + "dp_same:" + key] = np.array(
                np.array_equal(dev[0], dev[-1]))
        if rmin is not None:
            for path, leaf in jax.tree_util.tree_flatten_with_path(rmin)[0]:
                res[pre + "rmin:" + "/".join(str(k.key) for k in path)] = leaf
        for i, (path, leaf) in enumerate(
                jax.tree_util.tree_flatten_with_path(state)[0]):
            res[pre + f"state:{i}"] = np.asarray(leaf)
            res[pre + f"state_path:{i}"] = np.array(
                "/".join(str(getattr(k, "key", k)) for k in path))
        return res

    with ThreadPoolExecutor(3) as pool:
        futs = [pool.submit(equiv, *c) for c in EQUIV]
        futs += [pool.submit(trajectory, *TRAJ),
                 pool.submit(trajectory, *ZERO1)]
        for f in futs:
            out.update(f.result())
    use = resource.getrusage(resource.RUSAGE_SELF)
    out["seconds"] = np.array(time.monotonic() - t_start)
    out["cpu_seconds"] = np.array(use.ru_utime + use.ru_stime)
    np.savez(out_path, **out)


# ======================================================================
# the port's side
# ======================================================================
@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_tp_train") / "ref.npz"
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


def _tree(ref, prefix) -> dict:
    out: dict = {}
    for key, leaf in ref.items():
        if key.startswith(prefix):
            *path, name = key[len(prefix):].split("/")
            node = out
            for p in path:
                node = node.setdefault(p, {})
            node[name] = leaf
    return out


def _leaf(tree, key):
    for k in key.split("/"):
        tree = tree[k]
    return tree


def _ctx(dp=1, tp=1, backend="xla", disp="einsum"):
    from repro_torch.parallel import ParallelCtx
    return ParallelCtx(dp_size=dp, tp_size=tp, backend=backend,
                       moe_dispatch=disp, remat=True,
                       param_dtype=torch.float32, compute_dtype=torch.float32)


def _params(ref, arch):
    from repro_torch.weights import from_jax
    return from_jax(_tree(ref, f"params0:{arch}:"))


def _loss_grads(ref, arch, ctx):
    """The port's ``loss_and_grad`` on the reference's batch of 4 rows:
    (the loss shown, the global gradients of replica 0)."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.train import grad as tgrad
    from repro_torch.tree import tree_map
    from repro_torch.weights import shard_for_tp, unshard

    cfg = configs.get_smoke(arch)
    params = shard_for_tp(_params(ref, arch), cfg, ctx.tp_size)
    params = tgrad.trainable(lm.unstack(params))
    batch = {"tokens": torch.from_numpy(np.array(ref[f"tokens:{arch}"]))}
    loss, grads, _ = tgrad.loss_and_grad(lm.loss_fn, params, batch, ctx, cfg)
    g0 = tree_map(lambda g: g[0], grads)
    if ctx.tp_size > 1:
        g0 = unshard(g0, cfg, ctx.tp_size)
    return loss, g0


def _worst(got: dict, want: dict) -> float:
    """``run_tp_equiv``'s measure: the largest per-leaf max |a - b| over
    the leaf's largest |want|."""
    from repro_torch.tree import leaves
    worst = 0.0
    for key in [k for k in _flat_keys(want)]:
        a, c = _leaf(want, key), _leaf(got, key).numpy()
        assert a.shape == c.shape, key
        worst = max(worst, float(np.abs(a - c).max()
                                 / max(np.abs(a).max(), 1e-6)))
    assert len(leaves(got)) == len(_flat_keys(want))
    return worst


def _flat_keys(tree, pre=""):
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _flat_keys(v, pre + k + "/")
        else:
            out.append(pre + k)
    return out


@pytest.fixture(scope="module")
def port1(ref):
    """The port's tp = 1 loss and gradients, once per arch."""
    return {arch: _loss_grads(ref, arch, _ctx()) for arch in ARCHS}


@pytest.mark.parametrize("arch,backend,disp", EQUIV)
def test_dp2_tp4_matches_tp1_and_the_reference(ref, port1, arch, backend,
                                               disp):
    """(1): loss rtol 2e-5, gradients 5e-4 of each leaf's largest."""
    loss, grads = _loss_grads(ref, arch, _ctx(2, 4, backend, disp))
    assert loss.shape == (2, 4)
    assert torch.all(loss == loss[0, 0])
    pre = _key("equiv", arch, backend, disp, "")
    l1, g1 = port1[arch]
    np.testing.assert_allclose(float(loss[0, 0]), float(ref[pre + "loss"]),
                               rtol=2e-5)
    np.testing.assert_allclose(float(loss[0, 0]), float(l1[0]), rtol=2e-5)
    want = _tree(ref, pre + "grad:")
    assert _worst(grads, want) < 5e-4
    from repro_torch.tree import tree_map
    assert _worst(grads, tree_map(lambda t: t.numpy(), g1)) < 5e-4


def _port_traj(ref, arch, dp, tp, zero, clip):
    """The port's STEPS steps of (2)/(3): (metrics, state, cfg, ctx)."""
    from repro_torch import configs
    from repro_torch.data import SyntheticLM
    from repro_torch.models import registry
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.step import train_state_from

    cfg = configs.get_smoke(arch)
    ctx = _ctx(dp, tp)
    opt = AdamWConfig(lr=LR, zero=zero)
    state = train_state_from(_params(ref, arch), ctx, opt, cfg)
    step = make_train_step(cfg, ctx, registry.build(cfg), opt,
                           clip_norm=clip)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=cfg.max_seq,
                       global_batch=BATCH)
    metrics = []
    for s in range(STEPS):
        state, m = step(state, data.batch(s, device="cpu"))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return np.array(metrics), state, cfg, ctx


@pytest.fixture(scope="module")
def trajs(ref):
    return {run: _port_traj(ref, *run) for run in (TRAJ, ZERO1)}


def _per_pe(state, key, tp):
    """Every PE's local tensor of a parameter, (tp, *local), the layer
    axis first for a block leaf (the reference device's local leaf)."""
    head, _, rest = key.partition("/")
    if head == "blocks":
        layers = state["params"]["blocks"]
        return torch.stack([_leaf(layer, rest).detach() for layer in layers],
                           dim=1).numpy()
    return _leaf(state["params"], key).detach().numpy()


def _hold_pes(ref, pre, state, tp, rmin=True):
    """Every PE's parameters to the reference device's (module
    docstring); returns the replicated leaves' part between PE 0 and 1
    (max |difference|) in the port and in the reference."""
    parts = []
    for key in [k[len(pre + "param:"):] for k in ref
                if k.startswith(pre + "param:")]:
        want = ref[pre + "param:" + key]              # (tp, *local)
        assert bool(ref[pre + "dp_same:" + key]), key
        got = _per_pe(state, key, tp)
        assert got.shape == want.shape, key
        small = (ref[pre + "rmin:" + key] < 1e-4 if rmin
                 else np.zeros(want.shape, bool))
        np.testing.assert_allclose(got[~small], want[~small], rtol=2e-4,
                                   atol=2e-5, err_msg=key)
        assert np.all(np.abs(got - want)[small] <= 0.1 * LR), key
        if key.endswith("scale"):
            parts.append((float(np.abs(got[1] - got[0]).max()),
                          float(np.abs(want[1] - want[0]).max())))
    return parts


def test_clipped_dp2_tp4_trajectory_matches_per_pe(ref, trajs):
    """(2): the per-PE clip, PE for PE."""
    metrics, state, cfg, ctx = trajs[TRAJ]
    pre = _key("traj", *TRAJ, "")
    np.testing.assert_allclose(metrics, ref[pre + "metrics"], rtol=1e-5)
    assert np.all(ref[pre + "metrics"][:, 1] > TRAJ[-1])   # the clip bites
    parts = _hold_pes(ref, pre, state, 4)
    # the norms' copies part in the reference, and the port's by as much
    assert max(r for _, r in parts) > 0
    for got, want in parts:
        assert got == pytest.approx(want, rel=1e-2, abs=1e-7)


def test_zero1_dp2_tp2_matches_the_reference(ref, trajs):
    """(3): metrics, every PE's parameters, the state's global tree."""
    from repro_torch.train import state_to_tree
    from repro_torch.tree import leaves

    metrics, state, cfg, ctx = trajs[ZERO1]
    pre = _key("traj", *ZERO1, "")
    np.testing.assert_allclose(metrics, ref[pre + "metrics"], rtol=1e-5)
    _hold_pes(ref, pre, state, 2, rmin=False)
    tree = state_to_tree(state, cfg=cfg, ctx=ctx)
    got = leaves(tree)
    n = len([k for k in ref if k.startswith(pre + "state:")])
    assert len(got) == n
    for i, g in enumerate(got):
        want = ref[pre + f"state:{i}"]
        path = str(ref[pre + f"state_path:{i}"])
        assert tuple(g.shape) == want.shape, path
        if path.startswith("opt/"):            # m, v, master chunks
            np.testing.assert_allclose(g.numpy(), want, rtol=2e-4,
                                       atol=2e-5, err_msg=path)
    assert int(tree["opt"]["count"]) == int(tree["step"]) == STEPS


def test_tp4_checkpoint_resumes_at_tp1(ref, trajs):
    """(4): the TP-4 state's tree is the reference's layout; it loads at
    tp = 1 and back at tp = 4 exactly, and trains on."""
    from repro_torch import configs
    from repro_torch.data import SyntheticLM
    from repro_torch.models import lm, registry
    from repro_torch.train import (AdamWConfig, make_train_step,
                                   state_from_tree, state_to_tree)
    from repro_torch.train.step import train_state_from
    from repro_torch.tree import leaves

    _, state, cfg, ctx = trajs[TRAJ]
    pre = _key("traj", *TRAJ, "")
    tree = state_to_tree(state, cfg=cfg, ctx=ctx)
    got = leaves(tree)
    paths = [str(ref[pre + f"state_path:{i}"]) for i in range(len(got))]
    assert len([k for k in ref if k.startswith(pre + "state:")]) == len(got)
    for i, g in enumerate(got):
        assert tuple(g.shape) == ref[pre + f"state:{i}"].shape, paths[i]
    opt = AdamWConfig(lr=LR)
    fresh = lm.init(torch.Generator().manual_seed(5), cfg)
    one = state_from_tree(train_state_from(fresh, _ctx(), opt), tree)
    ctx4 = _ctx(1, 4)
    fresh = lm.init(torch.Generator().manual_seed(5), cfg)
    four = state_from_tree(train_state_from(fresh, ctx4, opt, cfg), tree,
                           cfg, ctx4)
    for back in (state_to_tree(one), state_to_tree(four, cfg=cfg, ctx=ctx4)):
        for a, b in zip(leaves(back), got):
            assert torch.equal(a, b)
    step = make_train_step(cfg, _ctx(), registry.build(cfg), opt)
    _, m = step(one, SyntheticLM(vocab=cfg.vocab, seq_len=cfg.max_seq,
                                 global_batch=4).batch(3, device="cpu"))
    assert np.isfinite(float(m["loss"])) and one["step"] == STEPS + 1


def test_build_trainer_at_tp4_on_the_cpu():
    """``build_trainer(tp_size=4, device="cpu", smoke=True)``: the
    TP layout, sequence parallelism on, the loss falls."""
    from repro_torch.launch import train as launch

    tr = launch.build_trainer("qwen3-8b", smoke=True, device="cpu",
                              tp_size=4, global_batch=4, lr=1e-2)
    assert tr.ctx.tp_size == 4
    assert tr.state["params"]["ln_f"]["scale"].shape == (4, 64)
    losses = [tr.step(s % 2)["loss"] for s in range(8)]
    assert losses[-1] < losses[0] - 0.1, losses
    stats = tr.ctx.tp_comm.stats()
    assert {"all_gather", "psum_scatter", "psum"} <= set(stats)


@pytest.mark.parametrize("arch", ["qwen3-8b", "qwen2-moe-a2.7b"])
def test_tp4_prefill_and_loss_equal_tp1(arch):
    """At TP 4 ``prefill`` (every PE's copy of the last position, after
    ``sp_gather``) and the vocab-parallel loss equal tp = 1's (1e-5: the
    same sums in another order), and so does the gathered CE (the vocab
    table all-gathered), which raised at tp > 1 before."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.data import SyntheticLM
    from repro_torch.models import lm
    from repro_torch.weights import shard_for_tp

    cfg = configs.get_smoke(arch)
    params = lm.init(torch.Generator().manual_seed(3), cfg)
    ids = torch.from_numpy(np.random.RandomState(4).randint(
        0, cfg.vocab, (2, 12)))
    ctx4 = _ctx(1, 4)
    p4 = shard_for_tp(params, cfg, 4)
    batch = SyntheticLM(vocab=cfg.vocab, seq_len=cfg.max_seq,
                        global_batch=2).batch(0, device="cpu")
    with torch.no_grad():
        want = lm.prefill(params, ids, _ctx(), cfg)
        got = lm.prefill(p4, ids, ctx4, cfg)
        loss1 = lm.loss_fn(params, batch, _ctx(), cfg)
        loss4 = lm.loss_fn(p4, batch, ctx4, cfg)
        gathered = lm.loss_fn(p4, batch, dataclasses.replace(
            ctx4, ce_mode="gathered"), cfg)
    assert got.shape == (4,) + tuple(want.shape)
    for pe in range(4):
        torch.testing.assert_close(got[pe], want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(loss4, loss1.expand(4), rtol=1e-5, atol=0)
    torch.testing.assert_close(gathered, loss1.expand(4), rtol=1e-5, atol=0)


def test_formerly_refused_tp_training_and_decode_run():
    """The ctx layout (heads not dividing tp), the other families and the
    contiguous-cache decode, which raised at tp > 1 citing A10, build
    and run: each family's train step at TP 4 takes a step with a finite
    loss, gemma's 4 heads take the ctx layout's all-replicated attention
    specs at tp 8, and the decode state builds; posh-micro, which raised
    citing A12 before, is the port's config and no ``raise`` of the port
    cites an A-label."""
    from repro_torch import configs
    from repro_torch.data import SyntheticLM
    from repro_torch.models import lm, registry
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.step import train_state_from

    ctx = _ctx(1, 4)
    for arch in ("minitron-4b", "rwkv6-3b", "zamba2-7b"):
        cfg = configs.get_smoke(arch)
        params = lm.init(torch.Generator().manual_seed(0), cfg)
        state = train_state_from(params, ctx, AdamWConfig(lr=LR), cfg)
        step = make_train_step(cfg, ctx, registry.build(cfg), AdamWConfig())
        batch = SyntheticLM(vocab=cfg.vocab, seq_len=cfg.max_seq,
                            global_batch=2).batch(0, device="cpu")
        _, m = step(state, batch)
        assert np.isfinite(float(m["loss"])), arch
    for arch in ("whisper-base", "llama-3.2-vision-90b"):
        cfg = configs.get_smoke(arch)
        make_train_step(cfg, ctx, registry.build(cfg), AdamWConfig())
    gemma = configs.get_smoke("gemma-2b")     # 4 heads: the ctx layout at 8
    attn = registry.tp_specs(gemma, 8)["blocks"]["attn"]
    assert set(attn.values()) == {None}
    cfg = configs.get_smoke("qwen3-8b")
    st = lm.init_decode_state(cfg, ctx, 1, 8, device="cpu")
    assert st["cache"]["k"].shape[:2] == (cfg.n_layers, 4)
    from repro_torch.configs import posh_micro
    from test_torch_imports import raises_citing_a_label
    assert configs.get("posh-micro") == posh_micro.config()
    assert raises_citing_a_label() == []


def test_collectives_differentiate_by_their_transposes():
    """psum, all_gather, psum_scatter and all_to_all under autograd on
    the stacked team: each backward is the transposed collective on the
    same communicator (counted in its stats), and equals autograd's own
    gradient of the xla forward written as plain tensor ops."""
    from repro_torch.comm import make_communicator

    rng = np.random.RandomState(0)
    x0 = torch.from_numpy(rng.randn(4, 3, 8, 2).astype(np.float32))
    ct = torch.from_numpy(rng.randn(4, 3, 8, 2).astype(np.float32))
    plain = {
        "psum": lambda x: x.sum(0, keepdim=True).expand_as(x),
        "psum_scatter": lambda x: torch.stack(
            x.sum(0).chunk(4, dim=1)),
        "all_gather": lambda x: torch.cat(list(x), dim=1)[None].expand(
            4, -1, -1, -1),
        "all_to_all": lambda x: torch.stack([
            torch.cat([x[j].chunk(4, dim=1)[i] for j in range(4)], dim=0)
            for i in range(4)]),
    }
    for backend in ("xla", "posh"):
        comm = make_communicator("pe", size=4, backend=backend)
        calls = {
            "psum": comm.psum,
            "psum_scatter": lambda x: comm.psum_scatter(x, axis=1),
            "all_gather": lambda x: comm.all_gather(x, axis=1),
            "all_to_all": lambda x: comm.all_to_all(x, split_axis=1,
                                                   concat_axis=0),
        }
        for op, fn in calls.items():
            x = x0.clone().requires_grad_(True)
            y = fn(x)
            want = plain[op](x0)
            torch.testing.assert_close(y.detach(), want)
            c = ct[:, :, :y.shape[2]] if y.shape == ct.shape else \
                torch.from_numpy(rng.randn(*y.shape).astype(np.float32))
            comm.reset_stats()
            (y * c).sum().backward()
            xr = x0.clone().requires_grad_(True)
            (plain[op](xr) * c).sum().backward()
            torch.testing.assert_close(x.grad, xr.grad, rtol=1e-5,
                                       atol=1e-5)
            back = {"psum": "psum", "psum_scatter": "all_gather",
                    "all_gather": "psum_scatter",
                    "all_to_all": "all_to_all"}[op]
            assert comm.stats()[back]["calls"] == 1, (backend, op)


def test_reference_worker_within_budget(ref):
    """The JAX worker's CPU seconds (compiles included: 4 DP2 x TP4
    loss-and-grad programs, 3 of them posh, and two 3-step trajectories)
    stay inside the tier-1 budget; its wall seconds are reported."""
    print(f"JAX worker: {float(ref['cpu_seconds']):.1f} CPU s, "
          f"{float(ref['seconds']):.1f} s of wall")
    assert float(ref["cpu_seconds"]) < 240


if __name__ == "__main__" and "--jax-worker" in sys.argv:
    _jax_worker(sys.argv[sys.argv.index("--jax-worker") + 1])
