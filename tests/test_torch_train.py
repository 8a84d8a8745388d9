"""repro_torch training against the JAX reference at the smoke size: the
same weights (JAX ``lm.init`` handed over through ``repro_torch.weights``)
and the same ``SyntheticLM`` batches go through the reference's train
step (``smap`` on a (1, 1) mesh, as ``tests/test_train.py`` runs it) and
the port's, for qwen3-8b-smoke and gemma-2b-smoke.  Then the reference's
own training properties on the port alone: microbatching is exact,
ZeRO-1 equals ZeRO-0, the loss falls over 40 steps.

Tolerances (f32 throughout): the loss and its gradients 1e-5 / 1e-4
(matrix products and reductions summed in another order); the 3-step
loss and grad-norm trajectory rtol 1e-5; the parameters after it rtol
2e-4 / atol 2e-5, the tolerance ``tests/test_train.py`` holds
microbatching to, on every element whose Adam denominator (the
bias-corrected rms of its clipped gradients) stayed above 1e-4.  Adam
moves a parameter by about ``lr * m / (sqrt(v) + eps)``, so for a small
gradient the step follows the gradient's own rounding: a JAX gemma
``wv`` gradient of 1.10e-8 is 1.29e-8 here (an error of 1e-7 of the
largest gradient, 1.3e-2), which moves that parameter 2e-4 apart after
one step.  The small-gradient elements (12-16% at these sizes) are held
to 0.1 x lr = 5e-4, 2.5x the largest difference measured.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import compat
from repro import configs as jconfigs
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import mlp as jmlp
from repro.models import registry as jregistry
from repro.parallel.ctx import ParallelCtx as JCtx
from repro.parallel.ctx import smap
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.optimizer import adamw_init as jadamw_init
from repro.train.step import make_train_step as jmake_train_step
from repro.train.step import train_state_specs
from repro_torch import configs
from repro_torch.data import SyntheticLM
from repro_torch.launch import train as launch
from repro_torch.models import common, lm, mlp, registry
from repro_torch.parallel import ParallelCtx
from repro_torch.train import AdamWConfig, make_train_step
from repro_torch.train import grad as tgrad
from repro_torch.train import tree
from repro_torch.train.step import train_state_from
from repro_torch.weights import from_jax

torch.set_num_threads(2)

ARCHS = ["qwen3-8b", "gemma-2b"]
STEPS = 3
LR = 5e-3
JCTX = JCtx(dp_size=1, tp_size=1, sp=False, remat=True,
            param_dtype=jnp.float32, compute_dtype=jnp.float32)
CTX = ParallelCtx(remat=True, param_dtype=torch.float32,
                  compute_dtype=torch.float32)


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _jax_run(arch):
    """The reference: init params, loss and grads at them, then STEPS
    train steps on SyntheticLM batches 0..STEPS-1."""
    cfg = jconfigs.get_smoke(arch)
    api = jregistry.build(cfg)
    opt = JAdamWConfig(lr=LR)
    mesh = compat.make_mesh((1, 1), ("data", "model"))
    params = api.init(jax.random.PRNGKey(0), cfg, JCTX)
    sspecs = train_state_specs(cfg, JCTX, api, opt)
    data = JSyntheticLM(vocab=cfg.vocab, seq_len=cfg.max_seq, global_batch=8)
    b0 = data.batch(0)
    loss, grads = jax.jit(smap(
        jax.value_and_grad(lambda p, bt: api.loss_fn(p, bt, JCTX, cfg)),
        mesh, (api.specs(cfg, JCTX), {"tokens": P("data")}),
        (P(), api.specs(cfg, JCTX))))(params, b0)
    state = {"params": params,
             "opt": smap(lambda p: jadamw_init(p, JCTX, opt), mesh,
                         (api.specs(cfg, JCTX),), sspecs["opt"])(params),
             "step": jnp.zeros((), jnp.int32)}
    fn = jax.jit(smap(jmake_train_step(cfg, JCTX, api, opt), mesh,
                      (sspecs, {"tokens": P("data")}),
                      (sspecs, {"loss": P(), "grad_norm": P(),
                                "step": P()})))
    metrics, rms = [], []
    for s in range(STEPS):
        state, m = fn(state, data.batch(s))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        bc2 = 1 - opt.b2 ** (s + 1)      # Adam's bias-corrected rms of g
        rms.append(jax.tree.map(lambda v: np.sqrt(np.asarray(v) / bc2),
                                state["opt"]["v"]))
    return {"params0": _np_tree(params), "loss0": float(loss),
            "grads0": _np_tree(grads), "metrics": metrics, "rms": rms,
            "params": _np_tree(state["params"])}


@pytest.fixture(scope="module")
def jax_runs():
    return {arch: _jax_run(arch) for arch in ARCHS}


def _port(arch, params_np, zero=0, microbatches=1):
    cfg = configs.get_smoke(arch)
    opt = AdamWConfig(lr=LR, zero=zero)
    state = train_state_from(from_jax(params_np), CTX, opt)
    step = make_train_step(cfg, CTX, registry.build(cfg), opt,
                           microbatches=microbatches)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=cfg.max_seq, global_batch=8)
    return cfg, state, step, data


def _stack(params):
    """The port's per-layer parameter tree in the reference's stacked
    layout (a detached copy)."""
    def st(items):
        if isinstance(items[0], dict):
            return {k: st([it[k] for it in items]) for k in items[0]}
        return torch.stack([it.detach() for it in items])
    return {**params, "blocks": st(params["blocks"])}


def _assert_tree_close(got, want, rtol, atol):
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == len(tree.leaves(got))
    for path, w in flat:
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node.detach().numpy(), w, rtol=rtol,
                                   atol=atol, err_msg=str(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_grads_match_jax(jax_runs, arch):
    ref = jax_runs[arch]
    cfg = configs.get_smoke(arch)
    params = tgrad.trainable(from_jax(ref["params0"]))
    batch = SyntheticLM(vocab=cfg.vocab, seq_len=cfg.max_seq,
                        global_batch=8).batch(0, device="cpu")
    loss = lm.loss_fn(params, batch, CTX, cfg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), ref["loss0"], rtol=1e-5)
    _assert_tree_close(tree.tree_map(lambda p: p.grad, params),
                       ref["grads0"], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_three_steps_match_jax_trajectory(jax_runs, arch):
    ref = jax_runs[arch]
    cfg, state, step, data = _port(arch, ref["params0"])
    got = []
    for s in range(STEPS):
        state, m = step(state, data.batch(s, device="cpu"))
        got.append((float(m["loss"]), float(m["grad_norm"])))
        assert m["step"] == s + 1
    np.testing.assert_allclose(np.array(got), np.array(ref["metrics"]),
                               rtol=1e-5)
    final = _stack(state["params"])
    n_small, n_all = 0, 0
    for path, want in jax.tree_util.tree_flatten_with_path(ref["params"])[0]:
        node, rms = final, ref["rms"]
        for key in path:
            node, rms = node[key.key], [r[key.key] for r in rms]
        got_p = node.detach().numpy()
        # small-gradient elements: Adam's denominator under 1e-4 at a step
        rmin = np.min([np.where(r > 0, r, np.inf) for r in rms], axis=0)
        small = rmin < 1e-4
        n_small += int(small.sum())
        n_all += small.size
        np.testing.assert_allclose(got_p[~small], want[~small],
                                   rtol=2e-4, atol=2e-5, err_msg=str(path))
        assert np.all(np.abs(got_p - want)[small] <= 0.1 * LR), path
    assert n_small < 0.25 * n_all          # 12% (qwen3) / 16% (gemma)


# ----------------------------------------------------------------------
# the reference's training properties (tests/test_train.py) on the port
# ----------------------------------------------------------------------
def _fresh(arch="qwen3-8b", zero=0, microbatches=1, lr=LR):
    cfg = configs.get_smoke(arch)
    opt = AdamWConfig(lr=lr, zero=zero)
    state = train_state_from(
        lm.init(torch.Generator().manual_seed(0), cfg), CTX, opt)
    step = make_train_step(cfg, CTX, registry.build(cfg), opt,
                           microbatches=microbatches)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=cfg.max_seq, global_batch=8)
    return state, step, data


def test_loss_decreases():
    state, step, data = _fresh()
    losses = []
    for s in range(40):
        state, m = step(state, data.batch(s, device="cpu"))
        losses.append(float(m["loss"]))
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < first - 0.15, f"no learning: {first:.3f} -> {last:.3f}"
    assert np.isfinite(losses).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatch_equivalence(arch):
    """Gradient accumulation over 4 microbatches == one batch step."""
    s1, f1, data = _fresh(arch, microbatches=1)
    s4, f4, _ = _fresh(arch, microbatches=4)
    b = data.batch(0, device="cpu")
    s1, m1 = f1(s1, b)
    s4, m4 = f4(s4, b)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-5)
    for a, c in zip(tree.leaves(s1["params"]), tree.leaves(s4["params"])):
        np.testing.assert_allclose(a.detach().numpy(), c.detach().numpy(),
                                   rtol=2e-4, atol=2e-5)


def test_zero1_matches_zero0_single_device():
    s0, f0, data = _fresh(zero=0)
    s1, f1, _ = _fresh(zero=1)
    for s in range(3):
        b = data.batch(s, device="cpu")
        s0, m0 = f0(s0, b)
        s1, m1 = f1(s1, b)
        np.testing.assert_allclose(float(m0["loss"]), float(m1["loss"]),
                                   rtol=1e-5)
    table = s1["params"]["embed"]["table"]                 # one flat chunk
    assert s1["opt"]["m"]["embed"]["table"].shape == (1, table.numel())
    for a, c in zip(tree.leaves(s0["params"]), tree.leaves(s1["params"])):
        np.testing.assert_allclose(a.detach().numpy(), c.detach().numpy(),
                                   rtol=2e-5, atol=2e-6)


# ----------------------------------------------------------------------
# data, weights, configs, the pieces the slice added
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dp_rank,dp_size,step", [(0, 1, 0), (0, 1, 7),
                                                  (1, 2, 3), (3, 4, 11)])
def test_synthetic_batches_byte_identical(dp_rank, dp_size, step):
    kw = dict(vocab=1000, seq_len=24, global_batch=8)
    want = np.asarray(JSyntheticLM(**kw).batch(step, dp_rank, dp_size)
                      ["tokens"])
    got = SyntheticLM(**kw).batch(step, dp_rank, dp_size, device="cpu")
    assert got["tokens"].dtype == torch.int32
    assert got["tokens"].numpy().tobytes() == want.tobytes()


def test_gemma_config_copy_matches_reference():
    for get in ("get", "get_smoke"):
        assert dataclasses.asdict(getattr(configs, get)("gemma-2b")) == \
            dataclasses.asdict(getattr(jconfigs, get)("gemma-2b"))


def test_from_jax_takes_tied_gemma_params(jax_runs):
    """gemma's params have no ``head`` (tied embeddings): every leaf
    arrives, and the loss reads the embedding table as the head."""
    jparams = jax_runs["gemma-2b"]["params0"]
    assert "head" not in jparams
    _assert_tree_close(from_jax(jparams), jparams, rtol=0, atol=0)
    assert "wg" in from_jax(jparams)["blocks"]["mlp"]


def test_from_jax_takes_relu2_mlps():
    """minitron's relu2 MLP has no ``wg``; the converted weights give the
    reference's MLP output."""
    jcfg = jconfigs.get_smoke("minitron-4b")
    assert jcfg.act == "relu2"
    jparams = _np_tree(jregistry.build(jcfg).init(jax.random.PRNGKey(1),
                                                  jcfg, JCTX))
    tparams = from_jax(jparams)
    assert set(tparams["blocks"]["mlp"]) == {"wu", "wd"}
    _assert_tree_close(tparams, jparams, rtol=0, atol=0)
    x = np.random.RandomState(2).randn(2, 5, jcfg.d_model).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"])["mlp"]
    want = jmlp.mlp_apply(jp, jnp.asarray(x), JCTX, jcfg)
    got = mlp.mlp_apply(lm.layer(tparams["blocks"], 0)["mlp"],
                        torch.from_numpy(x), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("name", ["gelu", "silu", "relu2"])
def test_act_fn_matches_reference(name):
    """gelu is the tanh approximation, as ``jax.nn.gelu`` by default."""
    from repro.models import common as jcommon
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    np.testing.assert_allclose(
        common.act_fn(name)(torch.from_numpy(x)).numpy(),
        np.asarray(jcommon.act_fn(name)(jnp.asarray(x))), rtol=1e-6,
        atol=1e-6)


def test_ce_chunks_and_gathered_mode_agree():
    """Chunked vocab-parallel CE (one checkpointed chunk per 5 tokens)
    equals the one-chunk and the naive gathered CE, grads included."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 12, 16).astype(np.float32))
    tg = torch.from_numpy(rng.randint(0, 40, (2, 12)).astype(np.int32))
    from repro_torch.models import embed
    res = []
    for ctx, chunk in ((CTX, 5), (CTX, None),
                       (dataclasses.replace(CTX, ce_mode="gathered"), None)):
        table = torch.from_numpy(np.linspace(-1, 1, 640, dtype=np.float32)
                                 .reshape(40, 16)).requires_grad_(True)
        loss = embed.lm_head_loss({"table": table}, x, tg, ctx, chunk=chunk)
        loss.backward()
        res.append((loss.detach(), table.grad))
    for got in res[1:]:
        torch.testing.assert_close(got[0], res[0][0])
        torch.testing.assert_close(got[1], res[0][1])


def test_later_slices_raise_not_implemented():
    """Data parallelism trains (A6): ``dp_size`` builds the DP
    communicator and its ranks, and at dp = 1 the DP flags give the
    trajectory without them (the reference reduces only at dp > 1).
    Tensor-parallel training of the dense and MoE families arrived with
    A10's MoE/TP slice: a tp = 2 step builds and the TP completion needs
    its specs; MoE trains (its loss runs and is finite).  Every other
    family at tp > 1 is ``test_torch_tp_ctx.py``'s and
    ``test_torch_tp_families.py``'s."""
    ctx = ParallelCtx(dp_size=2)
    assert ctx.dp_comm.size == 2 and ctx.dp_rank("cpu").tolist() == [0, 1]
    one = ctx.with_(dp_size=1)
    assert one.dp_comm.size == 1 and one.tp_comm is ctx.tp_comm
    cfg = configs.get_smoke("qwen3-8b")
    api = registry.build(cfg)
    # the trainer at tp = 2 builds (dense; MoE in test_torch_tp_train.py)
    make_train_step(cfg, ParallelCtx(tp_size=2), api, AdamWConfig())
    with pytest.raises(ValueError, match="config"):
        make_train_step(None, ParallelCtx(tp_size=2), api, AdamWConfig())
    with pytest.raises(ValueError, match="specs"):
        tgrad.combine_grads({}, None, ParallelCtx(tp_size=2), bucket_bytes=1)

    def losses(**kw):
        state, _, data = _fresh()
        step = make_train_step(cfg, CTX, api, AdamWConfig(lr=LR), **kw)
        return [float(step(state, data.batch(s, device="cpu"))[1]["loss"])
                for s in range(2)]

    base = losses()
    for kw in (dict(bucket_bytes=4096), dict(compress="bf16"),
               dict(overlap_grad_sync=True, bucket_bytes=4096)):
        assert losses(**kw) == base, kw
    g = {"w": torch.ones(1, 3)}
    assert tgrad.combine_grads(g, None, CTX, bucket_bytes=1, compress="bf16",
                               overlap=True) == (g, None)
    assert tgrad.overlapped_grad_sync(g, CTX.dp_comm) is g
    moe = configs.get_smoke("qwen3-moe-30b-a3b")
    api = registry.build(moe)          # MoE builds, decodes and trains
    loss = api.loss_fn(lm.init(torch.Generator().manual_seed(0), moe),
                       SyntheticLM(vocab=moe.vocab, seq_len=8, global_batch=2)
                       .batch(0, device="cpu"), CTX, moe)
    assert loss.shape == () and torch.isfinite(loss)
    with pytest.raises(ValueError, match="attn_impl"):
        ParallelCtx(attn_impl="pallas")


def test_loss_and_grad_returns_the_grads(jax_runs):
    ref = jax_runs["qwen3-8b"]
    cfg = configs.get_smoke("qwen3-8b")
    params = tgrad.trainable(lm.unstack(from_jax(ref["params0"])))
    batch = SyntheticLM(vocab=cfg.vocab, seq_len=cfg.max_seq,
                        global_batch=8).batch(0, device="cpu")
    loss, grads, comp = tgrad.loss_and_grad(lm.loss_fn, params, batch, CTX,
                                            cfg)
    assert comp is None and loss.shape == (1,)     # stacked over dp = 1
    np.testing.assert_allclose(float(loss), ref["loss0"], rtol=1e-5)
    _assert_tree_close(tree.tree_map(lambda g: g[0], grads), ref["grads0"],
                       rtol=1e-4, atol=1e-6)


def test_train_cli_runs_on_cpu_only_when_asked(capsys, tmp_path):
    launch.main(["--arch", "gemma-2b", "--smoke", "--device", "cpu",
                 "--steps", "2", "--microbatches", "2",
                 "--ckpt-dir", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert "arch=gemma-2b-smoke" in out and "training complete" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            launch.main(["--smoke", "--steps", "1"])
    # the DP flags: accepted, and at one device (dp = 1) they change
    # nothing, as the reference's CLI on one device
    base = launch.main(["--arch", "gemma-2b", "--smoke", "--device", "cpu",
                        "--steps", "2", "--ckpt-dir", str(tmp_path / "a")])
    flags = launch.main(["--arch", "gemma-2b", "--smoke", "--device", "cpu",
                         "--steps", "2", "--ckpt-dir", str(tmp_path / "b"),
                         "--backend", "xla", "--bucket-bytes", "4096",
                         "--overlap-grad-sync"])
    assert [m["loss"] for m in flags] == [m["loss"] for m in base]
    assert "backend=xla" in capsys.readouterr().out
    with pytest.raises(SystemExit):        # the reference's two backends
        launch.main(["--smoke", "--device", "cpu", "--backend", "pallas"])
    with pytest.raises(FileNotFoundError):  # nothing to resume from
        launch.main(["--smoke", "--device", "cpu", "--resume",
                     "--ckpt-dir", str(tmp_path / "ck")])
