"""Training with bf16 parameters and bf16 compute (the production ctx,
``launch.mesh.make_ctx``'s default) against the JAX reference's step on
the same weights and batch, on the CPU.

The reference runs ``make_train_step`` under ``smap`` on a (data, model)
mesh of CPU devices, which must be set before JAX starts, so this file
re-executes itself in a subprocess (``--jax-worker``) with four CPU
devices.  Cases (dp, tp, microbatches): (1, 1, 1), (1, 1, 2), (2, 2, 1)
and (2, 2, 2), qwen3-8b's smoke config, one step of AdamW (lr 1e-3,
clip 1.0).

Where the port departs from the reference on purpose: the port's
gradient rows are f32 at every microbatch count (each microbatch's bf16
gradient is added into its f32 row, ``train.grad._fold``), so its TP
completion, DP mean, norm and clip run in f32; the reference's gradients
stay bf16 at ``microbatches=1`` (its scan's f32 accumulator exists only
at ``microbatches > 1``) and its TP psum and DP pmean round each sum to
bf16.  The port is the more exact of the two; the bounds below are
bf16's, so they hold both ways of rounding.

Held to the reference, per case:

* the loss shown, within rtol 2**-7 (one bf16 ulp: both sides compute
  the logits and the CE in bf16, in another order);
* the grad norm shown, within rtol 2**-6;
* the global gradients (the port's reduced row 0, ``weights.unshard``-ed at
  tp > 1; the reference's ``loss_and_grad`` over each microbatch,
  averaged in f32): the whole tree's relative L2 error within 2**-5,
  and per leaf max |a - b| within 2**-4 of the leaf's largest |b|.
  That is twice bf16's own error here: at (1, 1, 1) each side's
  gradient is 1.6% (L2) from the port's f32-compute gradient of the
  same bf16 weights, up to 3.0% (port) and 3.4% (reference) of a
  leaf's largest; the two sides are 1.4-1.6% apart (printed);
* the updated parameters: the f32 masters move by lr x Adam's first
  step, sign(g) for every element whose |g| is well above eps, so where
  the two gradients cannot differ in sign (|g| above the gradient bound,
  2**-4 of the leaf's largest) the masters agree within 1e-6 + 1e-3 x
  lr, and every element within 2 lr + 1e-6 (a sign flip of a gradient
  below the bound: 1.07% of the leaf's largest was seen); the bf16
  parameters are the masters rounded, equal where the masters are.
"""
import os
import resource
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen3-8b"
LR = 1e-3
BATCH = 8
CASES = ((1, 1, 1), (1, 1, 2), (2, 2, 1), (2, 2, 2))


def _key(*parts) -> str:
    return ":".join(str(p) for p in parts)


def _f32(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32)


# ======================================================================
# the JAX worker (a subprocess with 4 CPU devices)
# ======================================================================
def _jax_worker(out_path: str) -> None:
    t_start = time.monotonic()
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro import compat, configs
    from repro.models import registry
    from repro.parallel.ctx import ParallelCtx, smap
    from repro.train.grad import loss_and_grad
    from repro.train.optimizer import AdamWConfig, adamw_init
    from repro.train.step import make_train_step, train_state_specs

    bf16 = dict(param_dtype=jnp.bfloat16, compute_dtype=jnp.bfloat16)
    cfg = configs.get_smoke(ARCH)
    api = registry.build(cfg)
    params = api.init(jax.random.PRNGKey(0), cfg,
                      ParallelCtx(dp_size=1, tp_size=1, sp=False, **bf16))
    tokens = jax.random.randint(jax.random.PRNGKey(1),
                                (BATCH, cfg.max_seq + 1), 0, cfg.vocab)
    out = {"tokens": np.asarray(tokens)}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        out["params0:" + "/".join(str(k.key) for k in path)] = _f32(leaf)

    def flat(prefix, tree):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out[prefix + "/".join(str(k.key) for k in path)] = _f32(leaf)

    for dp, tp, mb in CASES:
        mesh = compat.make_mesh((dp, tp), ("data", "model"),
                                devices=list(jax.devices()[:dp * tp]))
        ctx = ParallelCtx(dp_size=dp, tp_size=tp, sp=tp > 1, remat=True,
                          backend="xla", **bf16)
        specs = api.specs(cfg, ctx)
        pre = _key(dp, tp, mb, "")

        # the gradients: each microbatch's (TP-completed, DP-meaned)
        # through loss_and_grad, averaged in f32
        def fn(p, bt):
            _, g, _ = loss_and_grad(api.loss_fn, p, bt, ctx, cfg, specs)
            return g
        gfn = jax.jit(smap(fn, mesh, (specs, {"tokens": P("data")}),
                           specs))
        blocks = np.asarray(tokens).reshape(dp, mb, BATCH // (dp * mb), -1)
        acc = None
        for i in range(mb):
            g = gfn(params, {"tokens": jnp.asarray(
                blocks[:, i].reshape(BATCH // mb, -1))})
            g = jax.tree.map(_f32, g)
            acc = g if acc is None else jax.tree.map(np.add, acc, g)
        flat(pre + "grad:", jax.tree.map(lambda a: a / mb, acc))

        # one step of the reference's make_train_step
        opt = AdamWConfig(lr=LR)
        sspecs = train_state_specs(cfg, ctx, api, opt)
        init = jax.jit(smap(lambda p: adamw_init(p, ctx, opt), mesh,
                            (specs,), sspecs["opt"]))
        state = jax.device_put(
            {"params": params, "opt": init(params),
             "step": jnp.zeros((), jnp.int32)},
            jax.tree.map(lambda sp: NamedSharding(mesh, sp), sspecs,
                         is_leaf=lambda x: isinstance(x, P)))
        step = jax.jit(smap(make_train_step(cfg, ctx, api, opt,
                                            microbatches=mb), mesh,
                            (sspecs, {"tokens": P("data")}),
                            (sspecs, {"loss": P(), "grad_norm": P(),
                                      "step": P()})))
        state, m = step(state, {"tokens": tokens})
        out[pre + "metrics"] = np.array([float(m["loss"]),
                                         float(m["grad_norm"])])
        flat(pre + "param:", state["params"])
        flat(pre + "master:", state["opt"]["master"])
    use = resource.getrusage(resource.RUSAGE_SELF)
    out["seconds"] = np.array(time.monotonic() - t_start)
    out["cpu_seconds"] = np.array(use.ru_utime + use.ru_stime)
    np.savez(out_path, **out)


# ======================================================================
# the port's side
# ======================================================================
@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_bf16_train") / "ref.npz"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
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


def _flat(tree, pre="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, pre + k + "/"))
        else:
            out[pre + k] = v
    return out


def _port_step(ref, dp, tp, mb):
    """The port's step on the reference's weights and batch: (metrics,
    the reduced global gradients, the state after the step)."""
    from repro_torch import configs
    from repro_torch.models import registry
    from repro_torch.parallel import ParallelCtx
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train import grad as tgrad
    from repro_torch.train.step import _specs, train_state_from
    from repro_torch.tree import tree_map
    from repro_torch.weights import from_jax, unshard

    cfg = configs.get_smoke(ARCH)
    api = registry.build(cfg)
    ctx = ParallelCtx(dp_size=dp, tp_size=tp, sp=tp > 1, remat=True,
                      backend="xla", param_dtype=torch.bfloat16,
                      compute_dtype=torch.bfloat16)
    params = tree_map(lambda t: t.to(torch.bfloat16),
                      from_jax(_tree(ref, "params0:")))
    state = train_state_from(params, ctx, AdamWConfig(lr=LR), cfg)
    batch = {"tokens": torch.from_numpy(np.array(ref["tokens"]))}
    _, rows = tgrad.replica_grads(api.loss_fn, state["params"], batch, ctx,
                                  cfg, mb)
    with torch.no_grad():
        rows, _ = tgrad.combine_grads(rows, _specs(ctx, cfg), ctx,
                                      params=state["params"])
    grads = tree_map(lambda g: g[0], rows)
    if tp > 1:
        grads = unshard(grads, cfg, tp)
    step = make_train_step(cfg, ctx, api, AdamWConfig(lr=LR),
                           microbatches=mb)
    state, m = step(state, batch)
    return m, grads, state, cfg, ctx


def _global(state, cfg, ctx) -> tuple:
    """The state's parameters and f32 masters as the reference's global
    trees (``state_to_tree``) of numpy f32 leaves."""
    from repro_torch.train.step import state_to_tree
    from repro_torch.tree import tree_map
    t = state_to_tree(state, cfg=cfg, ctx=ctx)
    return tuple(_flat(tree_map(lambda x: x.float().numpy(), tree))
                 for tree in (t["params"], t["opt"]["master"]))


@pytest.mark.parametrize("dp,tp,mb", CASES)
def test_bf16_step_matches_the_reference(ref, dp, tp, mb):
    from repro_torch.tree import tree_map
    m, grads, state, cfg, ctx = _port_step(ref, dp, tp, mb)
    pre = _key(dp, tp, mb, "")
    want_loss, want_norm = ref[pre + "metrics"]
    assert abs(float(m["loss"]) - want_loss) <= 2 ** -7 * abs(want_loss)
    assert abs(float(m["grad_norm"]) - want_norm) <= 2 ** -6 * want_norm

    got = _flat(tree_map(lambda g: g.float().numpy(), grads))
    want = _flat(_tree(ref, pre + "grad:"))
    assert sorted(got) == sorted(want)
    worst, num, den = 0.0, 0.0, 0.0
    for k, b in want.items():
        a = got[k]
        assert a.shape == b.shape, k
        worst = max(worst, float(np.abs(a - b).max()
                                 / max(np.abs(b).max(), 1e-12)))
        num += float(np.sum((a - b) ** 2))
        den += float(np.sum(b ** 2))
    l2 = (num / den) ** 0.5
    print(f"dp {dp} tp {tp} mb {mb}: loss {float(m['loss']):.6f} / "
          f"{want_loss:.6f}, grad norm {float(m['grad_norm']):.6f} / "
          f"{want_norm:.6f}, grads worst leaf {worst:.2e}, l2 {l2:.2e}")
    assert worst <= 2 ** -4 and l2 <= 2 ** -5

    params, masters = _global(state, cfg, ctx)
    want_m = _flat(_tree(ref, pre + "master:"))
    want_p = _flat(_tree(ref, pre + "param:"))
    assert sorted(masters) == sorted(want_m) == sorted(params)
    for k, b in want_m.items():
        a, g = masters[k], want[k]
        d = np.abs(a - b)
        assert d.max() <= 2 * LR + 1e-6, k
        sure = np.abs(g) > 2 ** -4 * np.abs(g).max()     # no sign flip
        assert np.all(d[sure] <= 1e-6 + 1e-3 * LR), k
        same = d <= 1e-6 + 1e-3 * LR
        pa, pb = params[k], want_p[k]
        assert np.all(pa[same & (a == b)] == pb[same & (a == b)]), k
        assert np.array_equal(pa, torch.from_numpy(a).bfloat16().float()
                              .numpy()), k


def test_reference_worker_within_budget(ref):
    """The JAX worker's CPU seconds (8 compiles at smoke size)."""
    print(f"JAX worker: {float(ref['cpu_seconds']):.1f} CPU s, "
          f"{float(ref['seconds']):.1f} s")
    assert float(ref["cpu_seconds"]) < 120


if __name__ == "__main__" and "--jax-worker" in sys.argv:
    _jax_worker(sys.argv[sys.argv.index("--jax-worker") + 1])
