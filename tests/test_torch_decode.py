"""The contiguous-cache serving API (``init_decode_state``,
``decode_step``, ``prefill``) and its attention against the JAX reference
on the CPU, in f32 (the caches bf16, as the reference keeps them).

  * ``decode_step`` streams equal the reference's token for token over
    ``tests/test_models.py::test_smoke_decode``'s five archs (qwen3-8b,
    rwkv6-3b, zamba2-7b, h2o-danube-3-4b, gemma-2b) and a MoE config:
    two rows, a 4-token prompt, then greedy, 22 steps at ``max_len`` 24 —
    danube's smoke window of 16 makes its cache a ring that wraps six
    times; zamba2 threads one shared cache through its two applications
    of the shared block, as the reference does;
  * the decode state's keys, shapes and dtypes are the reference's, and
    after the steps its values (f32 states within 1e-5 x their largest,
    bf16 caches within one bf16 ulp of it, 2^-8; the hybrid's Mamba
    states, fed from bf16 conv buffers, 2^-6: ``MAMBA_STATE``);
  * ``prefill`` equals the reference's
    (``test_prefill_matches_forward_last_token``) within 1e-5 x the
    largest output, and the port's own ``forward``'s last row exactly;
  * ``decode_attention`` (with ``window``/``pos``), and
    ``decode_attention_partial`` + ``flash_combine`` over two halves of
    a cache equal the reference's and ``decode_attention`` (1e-6 x the
    largest output); ``init_cache`` is bf16 with the reference's shapes;
  * the port's ``ServeEngine`` streams equal the port's ``decode_step``
    streams (``tests/test_serve.py::test_engine_streams_match_contiguous
    _decode``'s contract), no tolerance;
  * the decode runs at tp > 1 in both attention layouts and equals tp
    = 1's stream (the full bar against the reference's mesh is
    ``test_torch_tp_ctx.py`` / ``test_torch_tp_families.py``).

The reference's decode step is jitted once per arch (module fixture).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import flash as jflash
from repro.models import registry as jregistry
from repro.parallel.ctx import ParallelCtx as JCtx
from repro_torch import configs, serve
from repro_torch.models import attention, flash, lm, registry
from repro_torch.parallel import ParallelCtx
from repro_torch.weights import from_jax

torch.set_num_threads(2)

ARCHS = ["qwen3-8b", "rwkv6-3b", "zamba2-7b", "h2o-danube-3-4b", "gemma-2b",
         "qwen2-moe-a2.7b"]
B, MAX_LEN, PROMPT, STEPS = 2, 24, 4, 22
JCTX = JCtx(dp_size=1, tp_size=1, sp=False, remat=False,
            param_dtype=jnp.float32, compute_dtype=jnp.float32)
CTX = ParallelCtx(remat=False, param_dtype=torch.float32,
                  compute_dtype=torch.float32)
BF16_ULP = 2.0 ** -8
# a Mamba layer reads its conv inputs back from bf16 buffers (the
# reference's state layout): an input a few f32 ulps off rounds to the
# neighbouring bf16 now and then, which moves the layer's SSM state and
# every later layer's; measured 0.45% of the largest element after 22
# steps, so the hybrid's layer states are held at 2^-6 of it
MAMBA_STATE = 2.0 ** -6


def _np(t):
    return jax.tree.map(np.asarray, t)


def _prompt(cfg):
    return np.random.RandomState(5).randint(0, cfg.vocab, (B, PROMPT)) \
        .astype(np.int32)


def _jax_stream(arch):
    """The reference: weights, the decode stream (the prompt fed, then
    greedy), the final state, and prefill of the prompt."""
    cfg = jconfigs.get_smoke(arch)
    api = jregistry.build(cfg)
    params = api.init(jax.random.PRNGKey(0), cfg, JCTX)
    step = jax.jit(lambda p, t, s: api.decode_step(p, t, s, JCTX, cfg))
    state = api.init_decode_state(cfg, JCTX, B, max_len=MAX_LEN)
    init = jax.tree.map(lambda a: (a.shape, str(a.dtype)), state)
    prompt = _prompt(cfg)
    tok, out = jnp.asarray(prompt[:, 0]), []
    for i in range(STEPS):
        if i < PROMPT:
            tok = jnp.asarray(prompt[:, i])
        tok, state = step(params, tok, state)
        out.append(np.asarray(tok))
    pre = None
    if arch in PREFILL:
        pre = np.asarray(jax.jit(lambda p, i: api.prefill(p, i, JCTX, cfg))(
            params, jnp.asarray(np.tile(prompt, (1, 3)))))
    return {"params": _np(params), "stream": np.stack(out, 1),
            "state": _np(state), "init": init, "prefill": pre}


PREFILL = ("qwen3-8b", "rwkv6-3b", "zamba2-7b")


@pytest.fixture(scope="module")
def ref():
    return {arch: _jax_stream(arch) for arch in ARCHS}


def _port_stream(arch, params):
    cfg = configs.get_smoke(arch)
    api = registry.build(cfg)
    state = api.init_decode_state(cfg, CTX, B, MAX_LEN, device="cpu")
    prompt = torch.from_numpy(_prompt(cfg))
    tok, out = prompt[:, 0], []
    with torch.no_grad():
        for i in range(STEPS):
            if i < PROMPT:
                tok = prompt[:, i]
            tok, state = api.decode_step(params, tok, state, CTX, cfg)
            out.append(tok.numpy())
    return np.stack(out, 1), state


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_streams_match_jax(ref, arch):
    r = ref[arch]
    got, state = _port_stream(arch, from_jax(r["params"]))
    assert state["pos"] == STEPS
    np.testing.assert_array_equal(got, r["stream"])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_matches_jax(ref, arch):
    """The layout of ``init_decode_state`` (keys, shapes, dtypes; ``pos``
    a Python int) and the state after the stream."""
    r = ref[arch]
    cfg = configs.get_smoke(arch)
    fresh = lm.init_decode_state(cfg, CTX, B, MAX_LEN, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(
        r["init"], is_leaf=lambda x: isinstance(x, tuple) and len(x) == 2
        and isinstance(x[1], str))[0]
    assert len(flat) == sum(len(v) if isinstance(v, dict) else 1
                            for v in fresh.values())
    for path, (shape, dtype) in flat:
        node = fresh
        for key in path:
            node = node[key.key]
        if path[0].key == "pos":
            assert node == 0
            continue
        assert (tuple(node.shape), str(node.dtype).split(".")[-1]) == \
            (tuple(shape), dtype), path
    _, state = _port_stream(arch, from_jax(r["params"]))
    for path, want in jax.tree_util.tree_flatten_with_path(r["state"])[0]:
        node = state
        for key in path:
            node = node[key.key]
        if path[0].key == "pos":
            assert node == int(want)
            continue
        got = node.float().numpy()
        want = np.asarray(want, np.float32)
        scale = float(np.abs(want).max()) or 1.0
        tol = BF16_ULP if node.dtype == torch.bfloat16 else 1e-5
        if cfg.family == "hybrid" and path[0].key == "cache":
            tol = MAMBA_STATE
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                                   err_msg=str(path))


@pytest.mark.parametrize("arch", PREFILL)
def test_prefill_matches_jax_and_forward(ref, arch):
    r = ref[arch]
    cfg = configs.get_smoke(arch)
    params = from_jax(r["params"])
    ids = torch.from_numpy(np.tile(_prompt(cfg), (1, 3)))
    with torch.no_grad():
        got = lm.prefill(params, ids, CTX, cfg)
        full = lm.forward(params, ids, CTX, cfg)
    assert got.shape == (B, cfg.d_model)
    want = r["prefill"]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
    assert torch.equal(got, full[:, -1])


# ======================================================================
# the decode attention
# ======================================================================
def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("case", ["plain", "window", "window_early"])
def test_decode_attention_matches_reference(case):
    b, h, hkv, s, dh = 3, 6, 2, 20, 16
    q, k, v = _rand(1, b, h, dh), _rand(2, b, s, hkv, dh), _rand(3, b, s, hkv,
                                                                   dh)
    kw = {"plain": {}, "window": {"window": 5, "pos": 12},
          "window_early": {"window": 5, "pos": 3}}[case]
    cur = 13
    want = jflash.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), cur, **kw)
    got = flash.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), cur, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))


def test_partial_and_combine_over_two_halves():
    """A cache split in two halves (the reference's sequence-sharded
    layout at two ranks, stacked on a leading PE axis here): each half's
    partial equals the reference's, and ``flash_combine`` with a stacked
    pmax / psum gives ``decode_attention`` of the whole."""
    b, h, hkv, s, dh = 2, 4, 2, 16, 8
    q, k, v = _rand(4, b, h, dh), _rand(5, b, s, hkv, dh), _rand(6, b, s, hkv,
                                                                   dh)
    cur = 11
    valid = np.arange(s)[None].repeat(b, 0) < cur
    parts = []
    for lo in (0, s // 2):
        sl = slice(lo, lo + s // 2)
        want = jflash.decode_attention_partial(
            jnp.asarray(q), jnp.asarray(k[:, sl]), jnp.asarray(v[:, sl]),
            jnp.asarray(valid[:, sl]))
        got = flash.decode_attention_partial(
            torch.from_numpy(q), torch.from_numpy(k[:, sl]),
            torch.from_numpy(v[:, sl]), torch.from_numpy(valid[:, sl]))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)
        parts.append(got)
    acc, m, l = (torch.stack(x) for x in zip(*parts))
    comb = {"pmax": lambda x: x.amax(0, keepdim=True).expand_as(x),
            "psum": lambda x: x.sum(0, keepdim=True).expand_as(x)}
    out = flash.flash_combine(acc, m, l, comb)
    whole = flash.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), cur)
    for pe in range(2):
        np.testing.assert_allclose(out[pe].reshape(b, h, dh).numpy(),
                                   whole.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", ["qwen3-8b", "h2o-danube-3-4b",
                                  "zamba2-7b"])
def test_init_cache_is_bf16_with_the_reference_shapes(arch):
    cfg = configs.get_smoke(arch)
    for max_len in (8, 40):
        want = jattn.init_cache(jconfigs.get_smoke(arch), JCTX, 3, max_len)
        got = attention.init_cache(cfg, 3, max_len)
        for key in ("k", "v"):
            assert got[key].dtype == torch.bfloat16
            assert tuple(got[key].shape) == want[key].shape
    if cfg.swa_window:
        assert attention.init_cache(cfg, 1, 40)["k"].shape[1] == \
            cfg.swa_window


# ======================================================================
# the engine against the contiguous decode, and refusals
# ======================================================================
def test_engine_streams_match_contiguous_decode():
    """The reference's ``test_serve.py`` contract on the port alone: the
    paged engine (continuous batching, chunked prefill) gives each
    request the stream of ``decode_step`` run on it alone."""
    cfg = configs.get_smoke("qwen3-8b")
    params = lm.init(torch.Generator().manual_seed(0), cfg)

    def contiguous(prompt, max_new):
        state = lm.init_decode_state(cfg, CTX, 1, 32, device="cpu")
        with torch.no_grad():
            for t in prompt:
                tok, state = lm.decode_step(params, torch.tensor([t]), state,
                                            CTX, cfg)
            out = [int(tok[0])]
            for _ in range(max_new - 1):
                tok, state = lm.decode_step(params, tok, state, CTX, cfg)
                out.append(int(tok[0]))
        return out

    prompts = [list(range(3, 9)), list(range(4, 10)), [7, 3, 99, 12]]
    scfg = serve.ServeConfig(page_tokens=4, n_pages=32, max_batch=3,
                             max_seq=32, attn_impl="kernel")
    eng = serve.ServeEngine(params, cfg, scfg, device="cpu")
    done = eng.run([serve.Request(rid=i, prompt=p, max_new=5)
                    for i, p in enumerate(prompts)], clock="tick")
    for r in sorted(done, key=lambda r: r.rid):
        assert r.out == contiguous(r.prompt, 5), f"req {r.rid}"


def test_tp_decode_runs_and_equals_tp1():
    """The contiguous-cache decode at tp > 1, refused (A10) before: the
    state stacked per PE (qwen3-8b at tp 2: each PE's KV head;
    minitron-4b's 6 heads at tp 4: the ctx layout's sequence-sharded
    cache, 2 rows a PE), every PE's pick equal and the stream equal to
    tp = 1's; the vlm's state builds; posh-micro, which raised citing A12
    before, is the port's config and no ``raise`` of the port cites an
    A-label; with no device given the state goes to the GPU."""
    from repro_torch.weights import shard_for_tp

    for arch, tp, shape in (("qwen3-8b", 2, (2, 1, 8, 1, 16)),
                            ("minitron-4b", 4, (4, 1, 2, 2, 16))):
        cfg = configs.get_smoke(arch)
        ctx = CTX.with_(tp_size=tp)
        assert cfg.attn_layout(tp) == ("ctx" if tp == 4 else "head")
        params = lm.init(torch.Generator().manual_seed(0), cfg)
        st1 = lm.init_decode_state(cfg, CTX, 1, 8, device="cpu")
        st2 = lm.init_decode_state(cfg, ctx, 1, 8, device="cpu")
        assert tuple(st2["cache"]["k"].shape[1:]) == shape
        p2 = shard_for_tp(params, cfg, tp)
        t1 = t2 = torch.tensor([7])
        with torch.no_grad():
            for _ in range(6):
                t1, st1 = lm.decode_step(params, t1, st1, CTX, cfg)
                t2, st2 = lm.decode_step(p2, t2, st2, ctx, cfg)
                assert t2.shape == (tp, 1)
                assert torch.equal(t2, t2[:1].expand(tp, 1))
                assert torch.equal(t2[0], t1)
    vlm = configs.get_smoke("llama-3.2-vision-90b")
    st = lm.init_decode_state(vlm, CTX.with_(tp_size=2), 1, 8, device="cpu")
    assert set(st) == {"cache", "cross_cache", "pos"}
    from repro_torch.configs import posh_micro
    from test_torch_imports import raises_citing_a_label
    assert configs.get("posh-micro") == posh_micro.config()
    assert raises_citing_a_label() == []
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            lm.init_decode_state(configs.get_smoke("qwen3-8b"), CTX, 1, 8)