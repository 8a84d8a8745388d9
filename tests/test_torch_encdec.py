"""whisper-base (the encoder-decoder family) against the JAX reference on
the CPU, at the smoke config, in f32 (the decode caches bf16, as the
reference keeps them).

The same numpy-seeded inputs and the same weights (the reference's
``init`` handed over through ``repro_torch.weights.from_jax``) go
through both packages:

  * ``_sinusoid`` at 1500 x 512 (the encoder's published length and
    width): the angles reach 1499 rad, and f32 ``pow``/``sin``/``cos`` of
    XLA and ATen differ by an ulp now and then (5% of the elements here,
    max |port - ref| 6.0e-8, an ulp of 1.0); held at ``SIN_TOL`` = 1e-6;
  * ``encode`` and ``decode_train`` within 1e-5 x the largest output;
  * ``loss_fn`` and its per-leaf gradients
    (``tests/test_models.py::test_smoke_loss_and_grads[whisper-base]``)
    within ``test_torch_train.py``'s 1e-5 (loss) and 1e-4 / 1e-6;
  * decode streams token for token from the same ``frames``
    (``test_smoke_decode_whisper``'s setup: ``PRNGKey(2)``), 10 greedy
    tokens, and a run from ``pos`` 510 across the end of the 512-row
    ``pos_dec`` table (the reference's clamp); the decode state's keys,
    shapes and dtypes, and its caches within a bf16 ulp of the largest
    element;
  * ``from_jax`` exact on the tree, the port's own init with the same
    keys and shapes, no ``head``; ``state_to_tree`` with the reference
    train state's layout;
  * three ``make_train_step`` steps in 2 microbatches (``frames`` split
    with the tokens) against the reference's: loss and grad norm rtol
    1e-5, each parameter leaf within ``PARAM_REL`` of the reference's own
    3-step movement (PR 25's rule);
  * DP 2 (each replica two rows in 2 microbatches) == dp = 1, and ZeRO-1
    over the encoder-decoder tree;
  * ``cut_layers`` (``n_layers`` and ``enc_layers`` together) and the
    CLI's refusal, naming ``frames``.

The reference runs jitted on one CPU device without ``smap`` (at dp = tp
= 1 its collectives are identities), each program compiled once in a
module-scoped fixture.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import encdec as jencdec
from repro.models import registry as jregistry
from repro.parallel.ctx import ParallelCtx as JCtx
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.optimizer import adamw_init as jadamw_init
from repro.train.step import make_train_step as jmake_train_step
from repro_torch import configs
from repro_torch.data import SyntheticLM
from repro_torch.launch import train as launch
from repro_torch.models import encdec, registry
from repro_torch.parallel import ParallelCtx
from repro_torch.train import AdamWConfig, make_train_step, state_to_tree
from repro_torch.train import grad as tgrad
from repro_torch.train import tree
from repro_torch.train.step import train_state_from
from repro_torch.weights import from_jax

torch.set_num_threads(2)

ARCH = "whisper-base"
BATCH, MB, STEPS, LR = 4, 2, 3, 5e-3
PARAM_REL = 1e-2            # PR 25's per-leaf rule (test_torch_families)
SIN_TOL = 1e-6
BF16_ULP = 2.0 ** -8
DEC_B, DEC_STEPS, DEC_LEN = 2, 10, 16
CLAMP_POS, CLAMP_STEPS = 510, 6     # the table has max_seq * 16 = 512 rows
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


def _close(got, want, rel=1e-5):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * float(np.abs(want).max()))


def _frames(cfg, step, b=BATCH):
    return (0.1 * np.random.RandomState(100 + step).randn(
        b, cfg.enc_frames, cfg.d_model)).astype(np.float32)


def _tokens(cfg, step):
    return np.asarray(JSyntheticLM(vocab=cfg.vocab, seq_len=cfg.max_seq,
                                   global_batch=BATCH).batch(step)["tokens"])


def _batch_np(cfg, step):
    return {"tokens": _tokens(cfg, step), "frames": _frames(cfg, step)}


def _batch(cfg, step):
    b = _batch_np(cfg, step)
    return {"tokens": torch.from_numpy(np.array(b["tokens"])).long(),
            "frames": _t(b["frames"])}


def _node(t, path):
    for key in path:
        t = t[key.key if hasattr(key, "key") else key]
    return t


# ======================================================================
# the reference's runs, once
# ======================================================================
@pytest.fixture(scope="module")
def ref():
    cfg = jconfigs.get_smoke(ARCH)
    api = jregistry.build(cfg)
    params = api.init(jax.random.PRNGKey(0), cfg, JCTX)
    batch0 = jax.tree.map(jnp.asarray, _batch_np(cfg, 0))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, bt: api.loss_fn(p, bt, JCTX, cfg)))(params, batch0)
    enc = jax.jit(lambda p, f: jencdec.encode(p, f, JCTX, cfg))
    dtrain = jax.jit(lambda p, i, e: jencdec.decode_train(p, i, e, JCTX,
                                                          cfg))
    enc0 = enc(params, batch0["frames"])
    out = {"params0": _np_tree(params), "loss0": float(loss),
           "grads0": _np_tree(grads), "enc0": np.asarray(enc0),
           "dec0": np.asarray(dtrain(params, batch0["tokens"][:, :-1],
                                     enc0))}
    # decode: test_smoke_decode_whisper's frames, then across the clamp
    frames = 0.1 * jax.random.normal(jax.random.PRNGKey(2),
                                     (DEC_B, cfg.enc_frames, cfg.d_model))
    ekv = jencdec.encoder_cross_kv(params, enc(params, frames), JCTX, cfg)
    step = jax.jit(lambda p, t, s, kv: api.decode_step(p, t, s, kv, JCTX,
                                                       cfg))
    streams = {}
    for name, pos0, n, max_len in (("start", 0, DEC_STEPS, DEC_LEN),
                                   ("clamp", CLAMP_POS, CLAMP_STEPS,
                                    CLAMP_POS + CLAMP_STEPS)):
        state = api.init_decode_state(cfg, JCTX, DEC_B, max_len=max_len)
        state["pos"] = jnp.asarray(pos0, jnp.int32)
        tok, toks = jnp.zeros((DEC_B,), jnp.int32), []
        for _ in range(n):
            tok, state = step(params, tok, state, ekv)
            toks.append(np.asarray(tok))
        streams[name] = (np.stack(toks, 1), _np_tree(state))
    out.update(frames=np.asarray(frames), streams=streams,
               init_state=jax.tree.map(
                   lambda a: (a.shape, str(a.dtype)),
                   api.init_decode_state(cfg, JCTX, DEC_B,
                                         max_len=DEC_LEN)))
    # three train steps in MB microbatches
    opt = JAdamWConfig(lr=LR)
    state = {"params": params, "opt": jadamw_init(params, JCTX, opt),
             "step": jnp.zeros((), jnp.int32)}
    fn = jax.jit(jmake_train_step(cfg, JCTX, api, opt, microbatches=MB))
    metrics = []
    for s in range(STEPS):
        state, m = fn(state, jax.tree.map(jnp.asarray, _batch_np(cfg, s)))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    out.update(metrics=metrics, params=_np_tree(state["params"]),
               layout=[(tuple(k.key for k in path), tuple(a.shape),
                        str(a.dtype))
                       for path, a in jax.tree_util.tree_flatten_with_path(
                           state)[0]])
    return out


# ======================================================================
# config, positions, modules
# ======================================================================
def test_config_copies_match_reference():
    for get in ("get", "get_smoke"):
        assert dataclasses.asdict(getattr(configs, get)(ARCH)) == \
            dataclasses.asdict(getattr(jconfigs, get)(ARCH))
    cfg = configs.get(ARCH)
    assert (cfg.family, cfg.n_layers, cfg.enc_layers, cfg.enc_frames) == \
        ("encdec", 6, 6, 1500)


def test_sinusoid_matches_reference():
    want = np.asarray(jax.jit(lambda: jencdec._sinusoid(1500, 512))())
    got = encdec._sinusoid(1500, 512).numpy()
    assert got.shape == (1500, 512) and got.dtype == np.float32
    err = float(np.abs(got - want).max())
    assert err <= SIN_TOL, err


def test_encode_and_decode_train_match_reference(ref):
    cfg = configs.get_smoke(ARCH)
    params = from_jax(ref["params0"])
    b = _batch(cfg, 0)
    with torch.no_grad():
        enc = encdec.encode(params, b["frames"], DCTX, cfg)
        _close(enc, ref["enc0"])
        dec = encdec.decode_train(params, b["tokens"][:, :-1],
                                  _t(ref["enc0"]), DCTX, cfg)
    assert dec.shape == (BATCH, cfg.max_seq, cfg.d_model)
    _close(dec, ref["dec0"])


# ======================================================================
# training
# ======================================================================
def test_loss_fn_and_grads_match_jax(ref):
    cfg = configs.get_smoke(ARCH)
    params = tgrad.trainable(from_jax(ref["params0"]))
    loss = encdec.loss_fn(params, _batch(cfg, 0), CTX, cfg)
    loss.backward()
    assert 3.0 < float(loss.detach()) < 7.0
    np.testing.assert_allclose(float(loss.detach()), ref["loss0"], rtol=1e-5)
    flat = jax.tree_util.tree_flatten_with_path(ref["grads0"])[0]
    assert len(flat) == len(tree.leaves(params))
    for path, want in flat:
        np.testing.assert_allclose(_node(params, path).grad.numpy(), want,
                                   rtol=1e-4, atol=1e-6, err_msg=str(path))


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
@pytest.mark.parametrize("run", ["start", "clamp"])
def test_decode_stream_and_state_match_jax(ref, run):
    """Token for token from the reference's frames; ``clamp`` starts at
    ``pos`` 510, so steps 2-5 read the table's last row, as the
    reference's ``min(pos, rows - 1)``.  The state after the steps:
    ``pos``, and the bf16 caches within a bf16 ulp of the largest."""
    cfg = configs.get_smoke(ARCH)
    params = from_jax(ref["params0"])
    assert params["pos_dec"].shape[0] == CLAMP_POS + 2
    api = registry.build(cfg)
    assert api.prefill is None
    want, jstate = ref["streams"][run]
    pos0, n, max_len = (0, DEC_STEPS, DEC_LEN) if run == "start" else (
        CLAMP_POS, CLAMP_STEPS, CLAMP_POS + CLAMP_STEPS)
    state = api.init_decode_state(cfg, DCTX, DEC_B, max_len, device="cpu")
    state["pos"] = pos0
    with torch.no_grad():
        enc = encdec.encode(params, _t(ref["frames"]), DCTX, cfg)
        ekv = encdec.encoder_cross_kv(params, enc, DCTX, cfg)
        assert ekv[0].shape == (cfg.n_layers, DEC_B, cfg.enc_frames,
                                cfg.n_kv, cfg.head_dim)
        tok, got = torch.zeros(DEC_B, dtype=torch.long), []
        for _ in range(n):
            tok, state = api.decode_step(params, tok, state, ekv, DCTX, cfg)
            got.append(tok.numpy())
    np.testing.assert_array_equal(np.stack(got, 1), want)
    assert state["pos"] == int(jstate["pos"]) == pos0 + n
    for k in ("k", "v"):
        mine = state["cache"][k]
        assert mine.dtype == torch.bfloat16
        _close(mine.float(), np.asarray(jstate["cache"][k], np.float32),
               BF16_ULP)


def test_decode_state_layout_matches_jax(ref):
    cfg = configs.get_smoke(ARCH)
    st = encdec.init_decode_state(cfg, DCTX, DEC_B, DEC_LEN, device="cpu")
    want = ref["init_state"]
    assert set(st) == set(want) == {"cache", "pos"}
    for k in ("k", "v"):
        shape, dtype = want["cache"][k]
        assert (tuple(st["cache"][k].shape),
                str(st["cache"][k].dtype).split(".")[-1]) == \
            (tuple(shape), dtype)
        assert not st["cache"][k].any()
    assert st["pos"] == 0


# ======================================================================
# the trees
# ======================================================================
def test_from_jax_takes_the_encdec_tree(ref):
    jparams = ref["params0"]
    tparams = from_jax(jparams)
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat) == len(tree.leaves(tparams))
    for path, leaf in flat:
        np.testing.assert_array_equal(_node(tparams, path).numpy(), leaf)
    cfg = configs.get_smoke(ARCH)
    mine = encdec.init(torch.Generator().manual_seed(0), cfg)
    assert tree.describe(mine) == tree.describe(tparams)
    assert "head" not in mine
    for path, leaf in flat:
        assert tuple(_node(mine, path).shape) == leaf.shape, path
    assert torch.all(mine["dec_blocks"]["lnx"]["bias"] == 0)


def test_state_has_the_reference_layout(ref):
    """``state_to_tree`` of a whisper train state has the reference train
    state's leaves, in its order, with its shapes and dtypes; the encoder
    and decoder blocks train as per-layer lists."""
    state = train_state_from(from_jax(ref["params0"]), CTX, AdamWConfig())
    assert isinstance(state["params"]["enc_blocks"], list)
    assert isinstance(state["params"]["dec_blocks"], list)
    got = state_to_tree(state)
    assert len(tree.leaves(got)) == len(ref["layout"])
    for path, shape, dtype in ref["layout"]:
        node = _node(got, path)
        assert (tuple(node.shape), str(node.dtype).split(".")[-1]) == \
            (shape, dtype), path


def test_dp2_equals_dp1_with_frames_split():
    """DP 2, each replica two of the four rows in 2 microbatches (its
    ``frames`` split with its tokens), equals one replica on all four
    (rtol 1e-5, PR 24's rule)."""
    cfg = configs.get_smoke(ARCH)
    out = []
    for dp, mb in ((1, 1), (2, 2)):
        ctx = ParallelCtx(dp_size=dp, backend="posh", remat=True,
                          param_dtype=torch.float32,
                          compute_dtype=torch.float32)
        opt = AdamWConfig(lr=LR)
        state = train_state_from(
            encdec.init(torch.Generator().manual_seed(3), cfg), ctx, opt)
        step = make_train_step(cfg, ctx, registry.build(cfg), opt,
                               microbatches=mb)
        out.append([float(step(state, _batch(cfg, s))[1]["loss"])
                    for s in range(2)])
    np.testing.assert_allclose(out[1], out[0], rtol=1e-5)
    bad = _batch(cfg, 0)
    bad["frames"] = bad["frames"][:2]
    with pytest.raises(ValueError, match="frames"):
        tgrad.replica_grads(encdec.loss_fn, tgrad.trainable(encdec.init(
            torch.Generator().manual_seed(3), cfg)), bad, CTX, cfg)


def test_zero1_over_the_encdec_tree():
    """ZeRO-1 at dp 1 gives ZeRO-0's trajectory (rtol 1e-5; parameters 2e-5
    / 2e-6), and at dp 2 every reference leaf (``pos_dec``, the stacked
    encoder and decoder weights) is ``(2, c)`` chunks whose
    ``state_to_tree`` view is the reference's ``(2 c,)``."""
    cfg = configs.get_smoke(ARCH)
    out = []
    for zero in (0, 1):
        opt = AdamWConfig(lr=LR, zero=zero)
        state = train_state_from(
            encdec.init(torch.Generator().manual_seed(4), cfg), CTX, opt)
        step = make_train_step(cfg, CTX, registry.build(cfg), opt)
        losses = [float(step(state, _batch(cfg, s))[1]["loss"])
                  for s in range(2)]
        out.append((losses, state))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-5)
    for a, b in zip(tree.leaves(out[0][1]["params"]),
                    tree.leaves(out[1][1]["params"])):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=2e-5, atol=2e-6)
    ctx = ParallelCtx(dp_size=2, backend="posh", remat=True,
                      param_dtype=torch.float32, compute_dtype=torch.float32)
    opt = AdamWConfig(lr=LR, zero=1)
    state = train_state_from(encdec.init(torch.Generator().manual_seed(4),
                                         cfg), ctx, opt)
    make_train_step(cfg, ctx, registry.build(cfg), opt)(state,
                                                        _batch(cfg, 0))
    m = state["opt"]["m"]
    assert set(m) == {"embed", "pos_dec", "enc_blocks", "ln_enc",
                      "dec_blocks", "ln_f"}
    wq = cfg.n_layers * cfg.d_model * cfg.n_heads * cfg.head_dim
    assert m["dec_blocks"]["xattn"]["wq"].shape == (2, -(-wq // 2))
    view = state_to_tree(state)["opt"]["m"]
    assert view["pos_dec"].shape == (2 * m["pos_dec"].shape[1],)


def test_cut_layers_and_the_cli_refusal():
    cut = launch.cut_layers(configs.get(ARCH), 2)
    assert (cut.n_layers, cut.enc_layers) == (2, 2)
    with pytest.raises(ValueError, match="'frames'"):
        launch.build_trainer(ARCH, smoke=True, device="cpu")
    with pytest.raises(ValueError, match="frames"):
        encdec.loss_fn(encdec.init(torch.Generator().manual_seed(0),
                                   configs.get_smoke(ARCH)),
                       {"tokens": torch.zeros((1, 5), dtype=torch.long)},
                       CTX, configs.get_smoke(ARCH))
    assert SyntheticLM(vocab=8, seq_len=4, global_batch=2).batch(
        0, device="cpu").keys() == {"tokens"}
