"""MoE training at tp = 1 against the JAX reference on the CPU, for the
smoke configs of qwen2-moe-a2.7b (60 -> 64 padded experts at full width,
6 -> 8 here, a shared expert) and qwen3-moe-30b-a3b.

The same weights (the reference's ``init`` handed over through
``repro_torch.weights.from_jax``) and the same ``SyntheticLM`` batches go
through both packages, all in f32:

  * ``loss_fn`` and its gradients: the loss within rtol 1e-5, every
    leaf's gradient within 1e-4 of that leaf's largest (matrix products
    and the scatter's sums in another order); the router, every expert
    and the shared expert included, and the padded experts' gradients
    (their router columns and expert tensors) exactly zero;
  * three ``make_train_step`` steps in 2 microbatches (the form of
    ``test_torch_train.py::test_three_steps_match_jax_trajectory``, its
    tolerances: loss and grad norm rtol 1e-5, the parameters rtol 2e-4 /
    atol 2e-5 on every element whose Adam denominator stayed above 1e-4,
    the others within 0.1 x lr), at capacity factor 1.0.  At the smoke width the MoE layers'
    gradients are small: 50-60% of the elements fall under the 1e-4
    rule (98% of the shared expert's, ~60% of the experts'; 12-16% in
    the dense models), so the guard on that share is 0.75 here, where
    that file has 0.25; the largest difference measured on them is 7.8e-5
    (0.016 x lr), on the others 2e-6;
  * DP 2 (in 2 microbatches) and ZeRO-1 at DP 2 on the stacked team,
    against the reference's (2, 1) mesh (a subprocess with 2 CPU
    devices, ``--jax-worker``): the loss and grad norm within rtol 1e-5,
    every parameter within 0.1 x lr and each leaf within 1e-2 of the
    reference's own 3-step movement of it (2-norms: the leaf rule of
    ``test_torch_families.py``).  Not the element rule: in the DP 2 run
    the reference's f32 parameters leave the port's f64 run (a
    yardstick of f32 rounding, not a reference) by up to 1.4e-4 on 4
    embedding elements whose Adam denominator is 3e-4..7e-4 (routing
    there has a top-2 / top-3 gate gap of 1.5e-5), while the port's f32
    run stays within 4.1e-6 of it;
  * the capacity-dropping variant: ``capacity_factor`` 1.0 in both
    packages' config (``dataclasses.replace``), where pairs DO drop
    (counted here; the smoke configs' 8.0 drops none, and there a
    choice-major or expert-sorted slot count would pass too).  Loss,
    gradients, the trajectory and the DP runs are held at this factor:
    capacity is counted token-major over each microbatch of each
    replica, so the gradient depends on the split, and the port's split
    is the reference's;
  * ``prefill`` of a MoE model: the last position's hidden state within
    1e-5 of the largest.

The reference's single-device programs run jitted without ``smap`` (at
dp = tp = 1 its collectives are identities), compiled once each in a
module-scoped fixture on a thread pool.
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

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["qwen2-moe-a2.7b", "qwen3-moe-30b-a3b"]
CFS = [None, 1.0]             # the smoke config's 8.0, and one that drops
STEPS = 3
LR = 5e-3
BATCH = 8
MB = 2
# the reference's DP 2 runs at capacity factor 1.0: each costs ~30 CPU s
# of trace and compile, so one a case: 2 microbatches a replica on the
# padded, shared-expert arch; ZeRO-1 on the other
DP_CASES = {"dp2_mb2": dict(microbatches=MB), "zero1": dict(zero=1)}
DP_RUNS = (("qwen2-moe-a2.7b", "dp2_mb2"), ("qwen3-moe-30b-a3b", "zero1"))


def _cfg(get, arch, cf):
    cfg = get(arch)
    if cf is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))


def _key(*parts) -> str:
    return ":".join(str(p) for p in parts)


# ======================================================================
# the reference
# ======================================================================
def _jax_setup():
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.parallel.ctx import ParallelCtx as JCtx

    jctx = JCtx(dp_size=1, tp_size=1, sp=False, remat=True,
                param_dtype=jnp.float32, compute_dtype=jnp.float32)
    return jax, jnp, jconfigs, jctx


def _flat(prefix, tree, out):
    import jax
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/".join(str(k.key) for k in path)] = np.asarray(leaf)


def _jax_steps(jax, jnp, cfg, fn, opt_state, params, out, prefix, opt,
               place=None):
    """STEPS steps of the jitted ``fn`` from ``params``; the metrics,
    the final parameters and each element's smallest Adam rms.  ``place``
    puts the state where ``fn`` returns it (its out shardings), so the
    second step does not compile again."""
    from repro.data import SyntheticLM as JSyntheticLM

    state = {"params": params, "opt": opt_state,
             "step": jnp.zeros((), jnp.int32)}
    if place is not None:
        state = place(state)
    data = JSyntheticLM(vocab=cfg.vocab, seq_len=cfg.max_seq,
                        global_batch=BATCH)
    metrics, rmin = [], None
    for s in range(STEPS):
        state, m = fn(state, data.batch(s))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        bc2 = 1 - opt.b2 ** (s + 1)
        rms = jax.tree.map(
            lambda v, p: np.sqrt(np.asarray(v).reshape(-1)[:p.size]
                                 .reshape(p.shape) / bc2),
            state["opt"]["v"], state["params"])
        rms = jax.tree.map(lambda r: np.where(r > 0, r, np.inf), rms)
        rmin = rms if rmin is None else jax.tree.map(np.minimum, rmin, rms)
    out[prefix + "metrics"] = np.array(metrics)
    _flat(prefix + "param:", state["params"], out)
    _flat(prefix + "rmin:", rmin, out)


def _jax_init(arch):
    """The reference's initial weights of ``arch`` (the capacity factor
    does not enter them)."""
    jax, _, jconfigs, jctx = _jax_setup()
    from repro.models import registry as jregistry

    cfg = jconfigs.get_smoke(arch)
    return jregistry.build(cfg).init(jax.random.PRNGKey(0), cfg, jctx)


def _jax_single(arch, cf, params):
    """The one-device programs of (arch, cf) from ``params``: loss and
    grads, and STEPS steps in MB microbatches (cf 1.0) or prefill (the
    smoke cf)."""
    jax, jnp, jconfigs, jctx = _jax_setup()
    from repro.data import SyntheticLM as JSyntheticLM
    from repro.models import lm as jlm
    from repro.models import registry as jregistry
    from repro.train.optimizer import AdamWConfig, adamw_init
    from repro.train.step import make_train_step

    cfg = _cfg(jconfigs.get_smoke, arch, cf)
    api = jregistry.build(cfg)
    out = {}
    _flat("params0:", params, out)
    batch = JSyntheticLM(vocab=cfg.vocab, seq_len=cfg.max_seq,
                         global_batch=BATCH).batch(0)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, bt: api.loss_fn(p, bt, jctx, cfg)))(params, batch)
    out["loss0"] = np.asarray(loss)
    _flat("grads0:", grads, out)
    if cf is not None:
        opt = AdamWConfig(lr=LR)
        fn = jax.jit(make_train_step(cfg, jctx, api, opt, microbatches=MB))
        _jax_steps(jax, jnp, cfg, fn, adamw_init(params, jctx, opt), params,
                   out, "steps:", opt)
    else:
        ids = np.asarray(batch["tokens"])[:4, :20]
        out["ids"] = ids
        out["prefill"] = np.asarray(jax.jit(
            lambda p, i: jlm.prefill(p, i, jctx, cfg))(params, ids))
    return {_key(arch, cf, k): v for k, v in out.items()}


@pytest.fixture(scope="module")
def worker(tmp_path_factory):
    """The 2-device JAX worker, started first so that it compiles beside
    the one-device programs; ``ref_dp`` waits for it."""
    path = tmp_path_factory.mktemp("jax_moe_dp") / "ref.npz"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--jax-worker", str(path)], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def ref1(worker):
    with ThreadPoolExecutor(3) as pool:
        params = dict(zip(ARCHS, pool.map(_jax_init, ARCHS)))
        runs = pool.map(lambda ac: _jax_single(*ac, params[ac[0]]),
                        [(a, c) for a in ARCHS for c in CFS])
        out = {}
        for r in runs:
            out.update(r)
    return out


def _jax_worker(out_path: str) -> None:
    """The DP 2 runs on a (2, 1) mesh of 2 CPU devices, each arch at
    capacity factor 1.0: 2 microbatches a replica, and ZeRO-1."""
    t_start = time.monotonic()
    jax, jnp, jconfigs, jctx = _jax_setup()
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro import compat
    from repro.models import registry as jregistry
    from repro.parallel.ctx import smap
    from repro.train.optimizer import AdamWConfig, adamw_init
    from repro.train.step import make_train_step, train_state_specs

    mesh = compat.make_mesh((2, 1), ("data", "model"))
    ctx = jctx.with_(dp_size=2)

    def run(arch, case):
        cfg = _cfg(jconfigs.get_smoke, arch, 1.0)
        api = jregistry.build(cfg)
        kw = dict(DP_CASES[case])
        opt = AdamWConfig(lr=LR, zero=kw.pop("zero", 0))
        sspecs = train_state_specs(cfg, ctx, api, opt)
        params = _jax_init(arch)
        fn = jax.jit(smap(make_train_step(cfg, ctx, api, opt, **kw), mesh,
                          (sspecs, {"tokens": P("data")}),
                          (sspecs, {"loss": P(), "grad_norm": P(),
                                    "step": P()})))
        init = jax.jit(smap(lambda p: adamw_init(p, ctx, opt), mesh,
                            (api.specs(cfg, ctx),), sspecs["opt"]))
        shardings = jax.tree.map(lambda sp: NamedSharding(mesh, sp), sspecs,
                                 is_leaf=lambda x: isinstance(x, P))
        out = {}
        _jax_steps(jax, jnp, cfg, fn, init(params), params, out,
                   _key(arch, case, ""), opt,
                   place=lambda st: jax.device_put(st, shardings))
        return out

    out = {}
    with ThreadPoolExecutor(2) as pool:
        for r in pool.map(lambda ac: run(*ac), DP_RUNS):
            out.update(r)
    use = resource.getrusage(resource.RUSAGE_SELF)
    out["seconds"] = np.array(time.monotonic() - t_start)
    out["cpu_seconds"] = np.array(use.ru_utime + use.ru_stime)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def ref_dp(worker):
    proc, path = worker
    log = proc.communicate(timeout=600)[0]
    assert proc.returncode == 0, log[-4000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# ======================================================================
# the port
# ======================================================================
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


def _ctx(dp=1):
    from repro_torch.parallel import ParallelCtx
    return ParallelCtx(dp_size=dp, remat=True, param_dtype=torch.float32,
                       compute_dtype=torch.float32)


def _batch(cfg, step=0):
    from repro_torch.data import SyntheticLM
    return SyntheticLM(vocab=cfg.vocab, seq_len=cfg.max_seq,
                       global_batch=BATCH).batch(step, device="cpu")


def _leaf(tree, key):
    for k in key.split("/"):
        tree = tree[k]
    return tree


def _count_drops(monkeypatch):
    """Record every routing call's dropped pairs: ``positions_in_expert``
    wrapped, the capacity ``int(n k cf / E) + 1`` recomputed from its
    n k pairs."""
    from repro_torch.models import mlp
    seen = []
    real = mlp.positions_in_expert

    def wrapped(idx_k, n_experts):
        pos = real(idx_k, n_experts)
        seen.append((pos.detach().clone(), idx_k.shape[-2] * idx_k.shape[-1],
                     n_experts))
        return pos
    monkeypatch.setattr(mlp, "positions_in_expert", wrapped)
    return seen


def _drops(seen, cfg) -> int:
    cf = cfg.moe.capacity_factor
    return sum(int((pos >= int(nk * cf / e) + 1).sum())
               for pos, nk, e in seen)


def _stack(params):
    def st(items):
        if isinstance(items[0], dict):
            return {k: st([it[k] for it in items]) for k in items[0]}
        return torch.stack([it.detach() for it in items])
    return {**params, "blocks": st(params["blocks"])}


def _hold_trajectory(metrics, final, ref, prefix, params0=None):
    """test_torch_train.py's trajectory rule, or with ``params0`` the
    leaf rule (module docstring)."""
    np.testing.assert_allclose(np.array(metrics), ref[prefix + "metrics"],
                               rtol=1e-5)
    if params0 is not None:
        for key in [k[len(prefix + "param:"):] for k in ref
                    if k.startswith(prefix + "param:")]:
            want = ref[prefix + "param:" + key]
            got = _leaf(final, key).detach().numpy()
            moved = np.linalg.norm(want - _leaf(params0, key))
            assert np.abs(got - want).max() <= 0.1 * LR, key
            assert np.linalg.norm(got - want) <= 1e-2 * moved, key
        return
    n_small = n_all = 0
    for key in [k[len(prefix + "param:"):] for k in ref
                if k.startswith(prefix + "param:")]:
        want = ref[prefix + "param:" + key]
        got = _leaf(final, key).detach().numpy()
        small = ref[prefix + "rmin:" + key] < 1e-4
        n_small += int(small.sum())
        n_all += small.size
        np.testing.assert_allclose(got[~small], want[~small], rtol=2e-4,
                                   atol=2e-5, err_msg=key)
        assert np.all(np.abs(got - want)[small] <= 0.1 * LR), key
    assert n_small < 0.75 * n_all


@pytest.mark.parametrize("cf", CFS)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(ref1, arch, cf, monkeypatch):
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.train import grad as tgrad
    from repro_torch.tree import tree_map
    from repro_torch.weights import from_jax

    cfg = _cfg(configs.get_smoke, arch, cf)
    params = tgrad.trainable(from_jax(_tree(ref1, _key(arch, cf,
                                                       "params0:"))))
    seen = _count_drops(monkeypatch)
    loss = lm.loss_fn(params, _batch(cfg), _ctx(), cfg, for_grad=True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()),
                               float(ref1[_key(arch, cf, "loss0")]),
                               rtol=1e-5)
    drops = _drops(seen, cfg)
    assert (drops > 0) == (cf is not None), drops
    grads = tree_map(lambda p: p.grad, params)
    want_all = _tree(ref1, _key(arch, cf, "grads0:"))
    for key in [k[len(_key(arch, cf, "grads0:")):] for k in ref1
                if k.startswith(_key(arch, cf, "grads0:"))]:
        want, got = _leaf(want_all, key), _leaf(grads, key).numpy()
        np.testing.assert_allclose(
            got, want, rtol=0, atol=1e-4 * max(np.abs(want).max(), 1e-30),
            err_msg=key)
    mlpg = grads["blocks"]["mlp"]
    m = cfg.moe
    assert float(mlpg["router"].abs().max()) > 0
    for name in ("wu", "wg", "wd"):
        assert float(mlpg[name][:, :m.num_experts].abs().max()) > 0
    if m.padded_experts:                     # qwen2-moe: 6 -> 8 experts
        pad = slice(m.num_experts, m.padded_experts)
        assert torch.all(mlpg["router"][..., pad] == 0)
        for name in ("wu", "wg", "wd"):
            assert torch.all(mlpg[name][:, pad] == 0), name
    if m.shared_ff:
        assert float(mlpg["shared"]["wd"].abs().max()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_three_steps_in_two_microbatches_match_jax(ref1, arch):
    from repro_torch import configs
    from repro_torch.models import registry
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.step import train_state_from
    from repro_torch.weights import from_jax

    cf = 1.0
    cfg = _cfg(configs.get_smoke, arch, cf)
    opt = AdamWConfig(lr=LR)
    state = train_state_from(from_jax(_tree(ref1, _key(arch, cf,
                                                       "params0:"))),
                             _ctx(), opt)
    step = make_train_step(cfg, _ctx(), registry.build(cfg), opt,
                           microbatches=MB)
    metrics = []
    for s in range(STEPS):
        state, m = step(state, _batch(cfg, s))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    _hold_trajectory(metrics, _stack(state["params"]), ref1,
                     _key(arch, cf, "steps:"))


@pytest.mark.parametrize("arch,case", DP_RUNS)
def test_dp2_and_zero1_match_the_reference_split(ref1, ref_dp, arch, case,
                                                 monkeypatch):
    """At capacity factor 1.0 each replica routes its own rows (and each
    microbatch its own), as each reference device does; pairs drop."""
    from repro_torch import configs
    from repro_torch.models import registry
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.step import train_state_from
    from repro_torch.weights import from_jax

    cfg = _cfg(configs.get_smoke, arch, 1.0)
    kw = dict(DP_CASES[case])
    opt = AdamWConfig(lr=LR, zero=kw.pop("zero", 0))
    ctx = _ctx(dp=2)
    params0 = _tree(ref1, _key(arch, 1.0, "params0:"))
    state = train_state_from(from_jax(params0), ctx, opt)
    step = make_train_step(cfg, ctx, registry.build(cfg), opt, **kw)
    seen = _count_drops(monkeypatch)
    metrics = []
    for s in range(STEPS):
        state, m = step(state, _batch(cfg, s))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    assert _drops(seen, cfg) > 0
    # each call routed one replica's microbatch: BATCH / 2 / mb rows
    rows = BATCH // 2 // kw.get("microbatches", 1)
    assert {nk for _, nk, _ in seen} == {rows * cfg.max_seq
                                         * cfg.moe.top_k}
    _hold_trajectory(metrics, _stack(state["params"]), ref_dp,
                     _key(arch, case, ""), params0)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(ref1, arch):
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.weights import from_jax

    cfg = configs.get_smoke(arch)
    params = from_jax(_tree(ref1, _key(arch, None, "params0:")))
    ids = torch.from_numpy(np.array(ref1[_key(arch, None, "ids")]))
    got = lm.prefill(params, ids, _ctx(), cfg)
    want = ref1[_key(arch, None, "prefill")]
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_reference_worker_within_budget(ref_dp):
    """The 2-device JAX worker's CPU seconds (compiles included) stay
    inside the tier-1 budget; its wall seconds are reported."""
    print(f"JAX worker: {float(ref_dp['cpu_seconds']):.1f} CPU s, "
          f"{float(ref_dp['seconds']):.1f} s of wall")
    assert float(ref_dp["cpu_seconds"]) < 120      # ~60 alone


def test_moe_trains_through_the_cli_and_build_trainer(tmp_path):
    """The CLI takes the MoE archs (``--layers`` keeps the first N at the
    config's width) and the loss falls over a few steps at the smoke
    size."""
    from repro_torch.launch import train as launch

    out = launch.main(["--arch", "qwen3-moe-30b-a3b", "--smoke", "--device",
                       "cpu", "--steps", "2", "--layers", "1",
                       "--ckpt-dir", str(tmp_path / "ck")])
    assert len(out) == 2 and all(np.isfinite(m["loss"]) for m in out)
    tr = launch.build_trainer("qwen2-moe-a2.7b", smoke=True, device="cpu",
                              global_batch=4, lr=1e-2)
    assert len(tr.state["params"]["blocks"]) == 2
    losses = [tr.step(s % 2)["loss"] for s in range(8)]
    assert losses[-1] < losses[0] - 0.1, losses


if __name__ == "__main__" and "--jax-worker" in sys.argv:
    _jax_worker(sys.argv[sys.argv.index("--jax-worker") + 1])
