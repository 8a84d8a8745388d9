"""repro_torch model functions and sampler against the JAX reference at
the qwen3-8b smoke size: the same numpy-seeded inputs and the same
weights (JAX ``lm.init`` handed over through ``repro_torch.weights``)
go through both packages.

Tolerances (f32 throughout): 1e-5 for norms and rope (elementwise f32,
ulp-level differences in rsqrt/sin/cos/pow), 1e-4 for the projections
and the MLP (matrix products summed in another order).  Candidate
indices, the threefry key words and uniform bits must be EQUAL.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import embed as jemb
from repro.models import lm as jlm
from repro.models import mlp as jmlp
from repro.models import registry
from repro.parallel.ctx import ParallelCtx
from repro.serve import sampling as jsampling
from repro_torch import configs
from repro_torch.models import attention, common, embed, lm, mlp
from repro_torch.serve import sampling, threefry
from repro_torch.weights import from_jax

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def smoke():
    """The smoke config, a tp=1 f32 JAX context, JAX weights, and the
    same weights in the port."""
    jcfg = jconfigs.get_smoke("qwen3-8b")
    ctx = ParallelCtx(dp_size=1, tp_size=1, sp=False, remat=False,
                      param_dtype=jnp.float32, compute_dtype=jnp.float32)
    jparams = registry.build(jcfg).init(jax.random.PRNGKey(0), jcfg, ctx)
    tparams = from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, configs.get_smoke("qwen3-8b"), ctx, jparams, tparams


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


def test_config_copy_matches_reference():
    for get in ("get", "get_smoke"):
        assert dataclasses.asdict(getattr(configs, get)("qwen3-8b")) == \
            dataclasses.asdict(getattr(jconfigs, get)("qwen3-8b"))


def test_rmsnorm_matches(smoke):
    rng = np.random.RandomState(0)
    x, scale = rng.randn(3, 5, 64), rng.rand(64) + 0.5
    want = jcommon.rmsnorm({"scale": jnp.asarray(scale, jnp.float32)},
                           jnp.asarray(x, jnp.float32))
    _close(common.rmsnorm(_t(scale), _t(x)), want, 1e-5)
    # bf16 in -> computed in f32 -> cast back, like the reference
    got = common.rmsnorm(_t(scale), _t(x).bfloat16())
    assert got.dtype == torch.bfloat16


@pytest.mark.parametrize("theta", [10000.0, 1000000.0])
def test_apply_rope_matches(theta):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 6, 4, 16)
    pos = np.array([[0, 1, 2, 3, 4, 5], [7, 8, 9, 30, 31, 2]], np.int32)
    want = jcommon.apply_rope(jnp.asarray(x, jnp.float32), jnp.asarray(pos),
                              theta)
    _close(common.apply_rope(_t(x), torch.from_numpy(pos), theta), want, 1e-5)


def test_project_qkv_matches(smoke):
    jcfg, cfg, ctx, jparams, tparams = smoke
    rng = np.random.RandomState(2)
    x = rng.randn(3, 5, cfg.d_model)
    pos = np.array([[0, 1, 2, 3, 4], [3, 4, 5, 6, 7], [9, 10, 11, 12, 13]],
                   np.int32)
    jp = jax.tree.map(lambda a: a[1], jparams["blocks"])["attn"]
    want = jattn.project_qkv(jp, jnp.asarray(x, jnp.float32),
                             jnp.asarray(pos), jcfg, ctx)
    got = attention.project_qkv(lm.layer(tparams["blocks"], 1)["attn"],
                                _t(x), torch.from_numpy(pos), cfg)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w, 1e-4)


def test_mlp_and_decode_mlp_match(smoke):
    jcfg, cfg, ctx, jparams, tparams = smoke
    rng = np.random.RandomState(3)
    x = rng.randn(4, 3, cfg.d_model)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"])["mlp"]
    tp = lm.layer(tparams["blocks"], 0)["mlp"]
    _close(mlp.mlp_apply(tp, _t(x), cfg),
           jmlp.mlp_apply(jp, jnp.asarray(x, jnp.float32), ctx, jcfg), 1e-4)
    _close(lm._decode_mlp(tp, _t(x[:, 0]), cfg),
           jlm._decode_mlp(jp, jnp.asarray(x[:, 0], jnp.float32), ctx, jcfg),
           1e-4)


def test_embed_lookup_and_lm_head_match(smoke):
    jcfg, cfg, ctx, jparams, tparams = smoke
    rng = np.random.RandomState(4)
    ids = rng.randint(0, cfg.vocab, size=(3, 7)).astype(np.int32)
    ids[0, 0] = cfg.vocab + 5                 # out of range -> zero row
    want = jemb.embed_lookup(jparams["embed"], jnp.asarray(ids), ctx)
    got = embed.embed_lookup(tparams["embed"], torch.from_numpy(ids),
                             torch.float32)
    _close(got, want, 0.0)
    assert float(got[0, 0].abs().max()) == 0.0
    x = rng.randn(3, cfg.d_model)
    _close(embed.lm_head_logits(tparams["head"], _t(x)),
           jemb.lm_head_logits(jparams["head"], jnp.asarray(x, jnp.float32),
                               ctx), 1e-4)


def test_top_k_ties_break_to_lowest_index(smoke):
    """Planted ties: equal logits resolve to the lowest index, as
    ``jax.lax.top_k`` does — candidate lists must be EQUAL."""
    ctx = smoke[2]
    rng = np.random.RandomState(5)
    logits = rng.randint(0, 4, size=(6, 40)).astype(np.float32)
    logits[0] = 1.0                           # everything tied
    logits[1, [3, 17, 30]] = 9.0              # tied maximum
    for k in (1, 4, 8):
        jv, ji = jemb.tp_sample_candidates(jnp.asarray(logits), ctx, k)
        tv, ti = embed.tp_sample_candidates(_t(logits), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert int(embed.tp_argmax(_t(logits))[1]) == 3
    np.testing.assert_array_equal(
        embed.tp_argmax(_t(logits)).numpy(),
        np.asarray(jemb.tp_argmax(jnp.asarray(logits), ctx)))


def test_init_uses_reference_distributions():
    cfg = configs.get_smoke("qwen3-8b")
    gen = torch.Generator().manual_seed(0)
    p = lm.init(gen, cfg)
    assert p["blocks"]["attn"]["wq"].shape == (cfg.n_layers, cfg.d_model,
                                               cfg.n_heads * cfg.head_dim)
    assert torch.all(p["blocks"]["ln1"]["scale"] == 1.0)
    assert torch.all(p["blocks"]["attn"]["q_norm"]["scale"] == 1.0)
    std = float(p["blocks"]["mlp"]["wd"].std())
    assert abs(std - cfg.d_ff ** -0.5) < 0.1 * cfg.d_ff ** -0.5
    assert abs(float(p["embed"]["table"].std()) - 0.02) < 0.004
    # same generator seed -> same weights
    q = lm.init(torch.Generator().manual_seed(0), cfg)
    assert torch.equal(p["blocks"]["mlp"]["wg"], q["blocks"]["mlp"]["wg"])


def test_from_jax_keeps_keys_and_stacking(smoke):
    jcfg, cfg, ctx, jparams, tparams = smoke
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat_j) == 14
    for path, leaf in flat_j:
        node = tparams
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


# ======================================================================
# threefry sampler: bit for bit against jax.random
# ======================================================================
@pytest.mark.parametrize("seed", [0, 7, -5, 2**31 - 1])
def test_threefry_keys_and_uniform_bits_equal_jax(seed):
    rids = np.array([0, 3, 99, 12345], np.int32)
    pos = np.array([0, 5, 1000, 77], np.int32)
    key = threefry.fold_in(threefry.fold_in(
        threefry.prng_key(torch.full((4,), seed)), torch.from_numpy(rids)),
        torch.from_numpy(pos))
    u = threefry.uniform(key, 8).numpy()
    for i in range(4):
        jk = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(np.int32(seed)), rids[i]), pos[i])
        assert [int(key[0][i]), int(key[1][i])] == \
            [int(w) for w in np.asarray(jk)]
        ju = np.asarray(jax.random.uniform(
            jk, (8,), minval=jnp.finfo(jnp.float32).tiny, maxval=1.0))
        np.testing.assert_array_equal(u[i].view(np.uint32), ju.view(np.uint32))


def test_sample_from_candidates_matches_jax():
    """Greedy and sampled rows (temperature, top-k, top-p) over many
    (seed, rid, position) keys: the drawn tokens are EQUAL."""
    rng = np.random.RandomState(6)
    b, k = 64, 8
    vals = -np.sort(-rng.randn(b, k).astype(np.float32) * 2, axis=1)
    idxs = rng.randint(0, 1000, size=(b, k)).astype(np.int32)
    state = {
        "temperature": np.where(np.arange(b) % 4 == 0, 0.0,
                                rng.uniform(0.3, 1.5, b)).astype(np.float32),
        "top_k": rng.randint(0, k + 1, b).astype(np.int32),
        "top_p": np.where(np.arange(b) % 3 == 0, 1.0,
                          rng.uniform(0.5, 1.0, b)).astype(np.float32),
        "rid": rng.randint(0, 50, b).astype(np.int32),
        "seed": np.int32(3),
    }
    pos = rng.randint(0, 4000, b).astype(np.int32)
    want = jsampling.sample_from_candidates(
        jnp.asarray(vals), jnp.asarray(idxs),
        {k_: jnp.asarray(v) for k_, v in state.items()}, jnp.asarray(pos))
    got = sampling.sample_from_candidates(_t(vals), torch.from_numpy(idxs),
                                          state, torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    greedy = state["temperature"] == 0
    np.testing.assert_array_equal(got.numpy()[greedy], idxs[greedy, 0])
