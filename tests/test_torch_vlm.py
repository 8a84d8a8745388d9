"""llama-3.2-vision-90b (the gated cross-attention vision-language
family) and the three cross-attention functions against the JAX
reference on the CPU, at the smoke config, in f32 (the decode caches
bf16, as the reference keeps them).

Both gates of every cross layer start at zero in the reference's init
(``lm.py:106``, ``:109``), which hides a wrong cross attention from the
loss, the decode and every gradient but the gates'.  Every comparison
here sets them non-zero, other values in each group (``GATES``: group 0
0.5 / -0.7, group 1 -0.3 / 0.4), in the parameters both packages get,
so a fault in the gates, the cross attention or the group order shows.
The image embeddings are unit normal: at test_models.py's 0.1 the
cross scores are nearly flat and the query projection's gradient ~2e-5,
inside the gradients' 1e-6 floor by a factor of 20 only; at 1.0 it is
~2e-3.

  * the config copies equal the reference's, field for field, and the
    port's published config counts ~90 B parameters
    (``tests/test_models.py::test_param_count_sanity``: 9.0e10 +- 30%);
  * ``cross_kv``, ``cross_attention`` (T 20 != S 12, blocks of 8: ragged
    on both axes) and ``decode_cross_attention`` at the vlm's (GQA 4 /
    2) and whisper's (4 / 4) smoke layouts within 1e-5 x the largest
    output; at tp 2 (the head layout on the stacked PEs) each PE's KV
    heads and output shard equal tp = 1's;
  * ``loss_fn`` and its per-leaf gradients within 1e-5 (loss) and 1e-4 /
    1e-6, the gates' gradients among them;
  * ``prefill`` within 1e-5 x the largest output;
  * decode streams token for token from the same ``img_kv`` (two rows, a
    4-token prompt, then greedy, 12 steps), the port's own ``cross_kv``
    giving that ``img_kv``; the decode state's keys, shapes and dtypes
    (``cross_cache`` too, the reference's ng zero caches, never read)
    and its caches within a bf16 ulp of the largest element;
  * ``from_jax`` exact, the port's init with the reference's keys and
    shapes (gates zero); ``state_to_tree`` with the reference train
    state's layout;
  * three ``make_train_step`` steps in 2 microbatches (``img_embeds``
    split with the tokens): loss and grad norm rtol 1e-5, each
    parameter leaf within ``PARAM_REL`` of the reference's own 3-step
    movement;
  * ``cut_layers`` keeps whole groups; the CLI refuses, naming
    ``img_embeds``; decode without ``img_kv`` raises as the reference's.

The reference runs jitted on one CPU device without ``smap``, each
program compiled once in a module-scoped fixture.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import attention as jattn
from repro.models import registry as jregistry
from repro.parallel.ctx import ParallelCtx as JCtx
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.optimizer import adamw_init as jadamw_init
from repro.train.step import make_train_step as jmake_train_step
from repro_torch import configs
from repro_torch.launch import train as launch
from repro_torch.models import attention, lm, registry
from repro_torch.parallel import ParallelCtx
from repro_torch.train import AdamWConfig, make_train_step, state_to_tree
from repro_torch.train import grad as tgrad
from repro_torch.train import tree
from repro_torch.train.step import train_state_from
from repro_torch.weights import from_jax

torch.set_num_threads(2)

ARCH = "llama-3.2-vision-90b"
GATES = {"xgate": (0.5, -0.3), "mgate": (-0.7, 0.4)}
BATCH, MB, STEPS, LR = 4, 2, 3, 5e-3
PARAM_REL = 1e-2            # PR 25's per-leaf rule (test_torch_families)
BF16_ULP = 2.0 ** -8
DEC_B, PROMPT, DEC_STEPS, DEC_LEN = 2, 4, 12, 16
JCTX = JCtx(dp_size=1, tp_size=1, sp=False, remat=True,
            param_dtype=jnp.float32, compute_dtype=jnp.float32)
CTX = ParallelCtx(remat=True, param_dtype=torch.float32,
                  compute_dtype=torch.float32)
DCTX = ParallelCtx(remat=False, param_dtype=torch.float32,
                   compute_dtype=torch.float32)


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _rand(seed, *shape, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


def _close(got, want, rel=1e-5):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * float(np.abs(want).max()))


def _node(t, path):
    for key in path:
        t = t[key.key if hasattr(key, "key") else key]
    return t


def _batch_np(cfg, step):
    tokens = np.asarray(JSyntheticLM(vocab=cfg.vocab, seq_len=cfg.max_seq,
                                     global_batch=BATCH).batch(step)["tokens"])
    return {"tokens": tokens,
            "img_embeds": _rand(200 + step, BATCH, cfg.img_tokens,
                                cfg.d_model)}


def _batch(cfg, step):
    b = _batch_np(cfg, step)
    return {"tokens": torch.from_numpy(np.array(b["tokens"])).long(),
            "img_embeds": _t(b["img_embeds"])}


def _prompt(cfg):
    return np.random.RandomState(5).randint(0, cfg.vocab, (DEC_B, PROMPT)) \
        .astype(np.int32)


def _gated(params):
    """The reference's params with both gates of every group non-zero."""
    cross = dict(params["cross"])
    for name, vals in GATES.items():
        cross[name] = jnp.asarray(vals, jnp.float32)[:, None]
    return {**params, "cross": cross}


# ======================================================================
# the reference's runs, once
# ======================================================================
@pytest.fixture(scope="module")
def ref():
    cfg = jconfigs.get_smoke(ARCH)
    api = jregistry.build(cfg)
    params = _gated(api.init(jax.random.PRNGKey(0), cfg, JCTX))
    batch0 = jax.tree.map(jnp.asarray, _batch_np(cfg, 0))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, bt: api.loss_fn(p, bt, JCTX, cfg)))(params, batch0)
    img = jnp.asarray(_rand(7, DEC_B, cfg.img_tokens, cfg.d_model))
    pre = jax.jit(lambda p, i, e: api.prefill(p, i, JCTX, cfg,
                                              img_embeds=e))(
        params, jnp.asarray(np.tile(_prompt(cfg), (1, 3))), img)
    ng = cfg.n_layers // cfg.cross_attn_every
    kvs = [jattn.cross_kv(jax.tree.map(lambda a: a[g], params["cross"])[
        "xattn"], img, JCTX, cfg) for g in range(ng)]
    img_kv = (jnp.stack([k for k, _ in kvs]), jnp.stack([v for _, v in kvs]))
    step = jax.jit(lambda p, t, s, kv: api.decode_step(p, t, s, JCTX, cfg,
                                                       img_kv=kv))
    state = api.init_decode_state(cfg, JCTX, DEC_B, max_len=DEC_LEN)
    init = jax.tree.map(lambda a: (a.shape, str(a.dtype)), state)
    prompt = _prompt(cfg)
    tok, out = jnp.asarray(prompt[:, 0]), []
    for i in range(DEC_STEPS):
        if i < PROMPT:
            tok = jnp.asarray(prompt[:, i])
        tok, state = step(params, tok, state, img_kv)
        out.append(np.asarray(tok))
    res = {"params0": _np_tree(params), "loss0": float(loss),
           "grads0": _np_tree(grads), "img": np.asarray(img),
           "prefill": np.asarray(pre), "img_kv": _np_tree(img_kv),
           "stream": np.stack(out, 1), "state": _np_tree(state),
           "init_state": init}
    opt = JAdamWConfig(lr=LR)
    st = {"params": params, "opt": jadamw_init(params, JCTX, opt),
          "step": jnp.zeros((), jnp.int32)}
    fn = jax.jit(jmake_train_step(cfg, JCTX, api, opt, microbatches=MB))
    metrics = []
    for s in range(STEPS):
        st, m = fn(st, jax.tree.map(jnp.asarray, _batch_np(cfg, s)))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    res.update(metrics=metrics, params=_np_tree(st["params"]),
               layout=[(tuple(k.key for k in path), tuple(a.shape),
                        str(a.dtype))
                       for path, a in jax.tree_util.tree_flatten_with_path(
                           st)[0]])
    return res


# ======================================================================
# config
# ======================================================================
def test_config_copies_match_reference():
    for get in ("get", "get_smoke"):
        assert dataclasses.asdict(getattr(configs, get)(ARCH)) == \
            dataclasses.asdict(getattr(jconfigs, get)(ARCH))
    n = configs.get(ARCH).param_count()
    assert abs(n - 9.0e10) / 9.0e10 < 0.3, n


# ======================================================================
# the three cross-attention functions
# ======================================================================
@pytest.mark.parametrize("arch", [ARCH, "whisper-base"])
def test_cross_attention_functions_match_reference(arch):
    cfg = jconfigs.get_smoke(arch)
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    p = {"wq": _rand(1, d, h * dh, scale=d ** -0.5),
         "wk": _rand(2, d, hkv * dh, scale=d ** -0.5),
         "wv": _rand(3, d, hkv * dh, scale=d ** -0.5),
         "wo": _rand(4, h * dh, d, scale=(h * dh) ** -0.5)}
    x, enc = _rand(5, 2, 20, d), _rand(6, 2, 12, d)
    jctx = JCtx(dp_size=1, tp_size=1, sp=False, remat=False,
                attn_block_q=8, attn_block_kv=8,
                param_dtype=jnp.float32, compute_dtype=jnp.float32)
    ctx = ParallelCtx(remat=False, attn_block_q=8, attn_block_kv=8,
                      param_dtype=torch.float32, compute_dtype=torch.float32)
    jp = jax.tree.map(jnp.asarray, p)
    tp = {k: _t(v) for k, v in p.items()}
    jkv = jax.jit(lambda pp, e: jattn.cross_kv(pp, e, jctx, cfg))(jp, enc)
    kv = attention.cross_kv(tp, _t(enc), ctx, cfg)
    assert kv[0].shape == (2, 12, hkv, dh)
    for a, b in zip(kv, jkv):
        _close(a, b)
    want = jax.jit(lambda pp, xx, k: jattn.cross_attention(pp, xx, k, jctx,
                                                           cfg))(jp, x, jkv)
    got = attention.cross_attention(tp, _t(x), kv, ctx, cfg)
    assert got.shape == (2, 20, d)
    _close(got, want)
    want = jax.jit(lambda pp, xx, k: jattn.decode_cross_attention(
        pp, xx, k, jctx, cfg))(jp, x[:, 3], jkv)
    _close(attention.decode_cross_attention(tp, _t(x[:, 3]), kv, ctx, cfg),
           want)
    # one query row against all S keys: the decode form equals the
    # sequence form's row
    _close(attention.decode_cross_attention(tp, _t(x[:, 3]), kv, ctx, cfg),
           got[:, 3].numpy())
    # at tp 2 (refused before, A10) on the stacked layout, every PE with
    # its copy of the encoder output: each PE's KV heads of the tp = 1
    # projection, the sequence shards of the tp = 1 output
    from repro_torch import configs as tconfigs
    from repro_torch.models.registry import tp_specs
    from repro_torch.weights import shard_leaf

    tcfg = tconfigs.get_smoke(arch)
    ctx2 = ctx.with_(tp_size=2)
    group = "cross" if tcfg.family == "vlm" else "dec_blocks"
    spec = tp_specs(tcfg, 2)[group]["xattn"]
    p2 = {k: shard_leaf(v, spec[k], False, 2) for k, v in tp.items()}
    kv2 = attention.cross_kv(p2, _t(enc).expand(2, -1, -1, -1), ctx2, cfg)
    for a, b in zip(kv2, kv):
        assert a.shape == (2, 2, 12, hkv // 2, dh)
        torch.testing.assert_close(a, torch.stack(b.chunk(2, dim=2)),
                                   rtol=1e-5, atol=1e-6)
    shards = torch.stack(_t(x).chunk(2, dim=1))
    out2 = attention.cross_attention(p2, shards, kv2, ctx2, cfg)
    _close(torch.cat(list(out2), dim=1), got.numpy())


# ======================================================================
# training, prefill
# ======================================================================
def test_loss_fn_and_grads_match_jax(ref):
    cfg = configs.get_smoke(ARCH)
    params = tgrad.trainable(from_jax(ref["params0"]))
    for name, vals in GATES.items():
        np.testing.assert_array_equal(
            params["cross"][name][:, 0].detach().numpy(),
            np.float32(vals))
    loss = lm.loss_fn(params, _batch(cfg, 0), CTX, cfg)
    loss.backward()
    assert 3.0 < float(loss.detach()) < 7.0
    np.testing.assert_allclose(float(loss.detach()), ref["loss0"], rtol=1e-5)
    flat = jax.tree_util.tree_flatten_with_path(ref["grads0"])[0]
    assert len(flat) == len(tree.leaves(params))
    for path, want in flat:
        np.testing.assert_allclose(_node(params, path).grad.numpy(), want,
                                   rtol=1e-4, atol=1e-6, err_msg=str(path))
    assert np.abs(ref["grads0"]["cross"]["xattn"]["wq"]).max() > 1e-3


def test_prefill_matches_reference(ref):
    cfg = configs.get_smoke(ARCH)
    params = from_jax(ref["params0"])
    ids = torch.from_numpy(np.tile(_prompt(cfg), (1, 3))).long()
    with torch.no_grad():
        got = lm.prefill(params, ids, DCTX, cfg, img_embeds=_t(ref["img"]))
        full = lm.forward(params, ids, DCTX, cfg, img_embeds=_t(ref["img"]))
    _close(got, ref["prefill"])
    assert torch.equal(got, full[:, -1])
    with pytest.raises(ValueError, match="img_embeds"):
        lm.prefill(params, ids, DCTX, cfg)


def _stack(params):
    def st(items):
        if isinstance(items[0], dict):
            return {k: st([it[k] for it in items]) for k in items[0]}
        return torch.stack([it.detach() for it in items])
    return {k: st(v) if isinstance(v, list) else v for k, v in params.items()}


def test_three_steps_match_jax_trajectory(ref):
    cfg = configs.get_smoke(ARCH)
    opt = AdamWConfig(lr=LR)
    state = train_state_from(from_jax(ref["params0"]), CTX, opt)
    step = make_train_step(cfg, CTX, registry.build(cfg), opt,
                           microbatches=MB)
    got = []
    for s in range(STEPS):
        state, m = step(state, _batch(cfg, s))
        got.append((float(m["loss"]), float(m["grad_norm"])))
    np.testing.assert_allclose(np.array(got), np.array(ref["metrics"]),
                               rtol=1e-5)
    final = _stack(state["params"])
    for path, want in jax.tree_util.tree_flatten_with_path(ref["params"])[0]:
        off = float(np.linalg.norm(_node(final, path).detach().numpy()
                                   - want))
        moved = float(np.linalg.norm(want - _node(ref["params0"], path)))
        assert off <= PARAM_REL * moved, (path, off, moved)


# ======================================================================
# decode
# ======================================================================
def test_decode_stream_and_state_match_jax(ref):
    cfg = configs.get_smoke(ARCH)
    params = from_jax(ref["params0"])
    api = registry.build(cfg)
    ng = cfg.n_layers // cfg.cross_attn_every
    with torch.no_grad():
        mine = [attention.cross_kv(lm.layer(params["cross"], g)["xattn"],
                                   _t(ref["img"]), DCTX, cfg)
                for g in range(ng)]
    img_kv = tuple(_t(a) for a in ref["img_kv"])
    for i in range(2):
        _close(torch.stack([kv[i] for kv in mine]), ref["img_kv"][i])
    state = api.init_decode_state(cfg, DCTX, DEC_B, DEC_LEN, device="cpu")
    prompt = torch.from_numpy(_prompt(cfg))
    tok, out = prompt[:, 0], []
    with torch.no_grad():
        for i in range(DEC_STEPS):
            if i < PROMPT:
                tok = prompt[:, i]
            tok, state = api.decode_step(params, tok, state, DCTX, cfg,
                                         img_kv=img_kv)
            out.append(tok.numpy())
    np.testing.assert_array_equal(np.stack(out, 1), ref["stream"])
    jstate = ref["state"]
    assert state["pos"] == int(jstate["pos"]) == DEC_STEPS
    for key in ("cache", "cross_cache"):
        for k in ("k", "v"):
            assert state[key][k].dtype == torch.bfloat16
            _close(state[key][k].float(),
                   np.asarray(jstate[key][k], np.float32), BF16_ULP)
    assert not state["cross_cache"]["k"].any()
    with pytest.raises(ValueError, match="img_kv"):
        api.decode_step(params, tok, state, DCTX, cfg)


def test_decode_state_layout_matches_jax(ref):
    cfg = configs.get_smoke(ARCH)
    st = lm.init_decode_state(cfg, DCTX, DEC_B, DEC_LEN, device="cpu")
    want = ref["init_state"]
    assert set(st) == set(want) == {"cache", "cross_cache", "pos"}
    for key in ("cache", "cross_cache"):
        for k in ("k", "v"):
            shape, dtype = want[key][k]
            assert (tuple(st[key][k].shape),
                    str(st[key][k].dtype).split(".")[-1]) == \
                (tuple(shape), dtype)
    assert st["pos"] == 0


# ======================================================================
# the trees, the depth cut
# ======================================================================
def test_from_jax_takes_the_vlm_tree(ref):
    jparams = ref["params0"]
    tparams = from_jax(jparams)
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat) == len(tree.leaves(tparams))
    for path, leaf in flat:
        np.testing.assert_array_equal(_node(tparams, path).numpy(), leaf)
    cfg = configs.get_smoke(ARCH)
    mine = lm.init(torch.Generator().manual_seed(0), cfg)
    assert tree.describe(mine) == tree.describe(tparams)
    for path, leaf in flat:
        assert tuple(_node(mine, path).shape) == leaf.shape, path
    for name in GATES:
        assert not mine["cross"][name].any()          # gated off at init


def test_state_has_the_reference_layout(ref):
    state = train_state_from(from_jax(ref["params0"]), CTX, AdamWConfig())
    assert isinstance(state["params"]["cross"], list)
    got = state_to_tree(state)
    assert len(tree.leaves(got)) == len(ref["layout"])
    for path, shape, dtype in ref["layout"]:
        node = _node(got, path)
        assert (tuple(node.shape), str(node.dtype).split(".")[-1]) == \
            (shape, dtype), path


def test_cut_layers_keeps_whole_groups():
    cut = launch.cut_layers(configs.get(ARCH), 10)
    assert (cut.n_layers, cut.n_layers // cut.cross_attn_every) == (10, 2)
    with pytest.raises(ValueError, match="whole groups"):
        launch.cut_layers(configs.get(ARCH), 7)
    with pytest.raises(ValueError, match="'img_embeds'"):
        launch.build_trainer(ARCH, smoke=True, device="cpu")
