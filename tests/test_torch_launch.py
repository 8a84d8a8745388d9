"""repro_torch.launch's tooling against repro.launch's: the shape tables,
the production team and its ctx, the H100 roofline, and the dry run on
the meta device.

* ``SHAPES``, ``LONG_OK``, ``TRAIN_MICROBATCH``, ``microbatches_for``,
  ``runs_shape`` and both ``model_flops_*`` equal the reference's for
  every arch x shape;
* one smoke cell a family (dense, moe, ssm, hybrid, encdec, vlm) runs on
  meta on a (2, 4) team: its matrix-product FLOPs equal an analytic
  count — closed forms from the config (projections, K/V replicated
  where n_kv < tp, the router and the experts' capacity buffers, cross
  K/V of the image rows or frames, RWKV's replicated LoRAs and chunked
  WKV, Mamba2's replicated B / C and chunked SSD on the padded
  sequence), also equal to the sum of 2 m n k over the products the
  pass ran — and the flash kernel's meta route its visible-pairs count;
  a training step and a decode step run too;
* the flash wrapper's meta route: shapes, dtypes and operation count,
  and no route for any device but meta, CPU and CUDA.
"""
import math

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jconfigs
from repro.launch import roofline as jroofline
from repro.launch import shapes as jshapes
from repro_torch import configs
from repro_torch.core.teams import Team
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import dryrun, mesh, roofline, shapes

ARCHS = ["minitron-4b", "gemma-2b", "qwen3-8b", "h2o-danube-3-4b",
         "whisper-base", "rwkv6-3b", "qwen2-moe-a2.7b", "qwen3-moe-30b-a3b",
         "llama-3.2-vision-90b", "zamba2-7b"]
TEAM = Team(("data", "model"), (2, 4))
ROWS, TP = 4, 4                   # the smoke cells' global batch, TP


def test_shape_tables_equal_the_reference():
    assert shapes.SHAPES == jshapes.SHAPES
    assert shapes.LONG_OK == jshapes.LONG_OK
    assert shapes.TRAIN_MICROBATCH == jshapes.TRAIN_MICROBATCH
    for arch in ARCHS + ["unknown-arch"]:
        assert shapes.microbatches_for(arch) == jshapes.microbatches_for(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_runs_shape_and_model_flops_equal_the_reference(arch):
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    for name, info in shapes.SHAPES.items():
        assert shapes.runs_shape(cfg, name) == jshapes.runs_shape(jcfg, name)
        gb, t = info["global_batch"], info["seq"]
        assert roofline.model_flops_train(cfg, gb * t) == \
            jroofline.model_flops_train(jcfg, gb * t)
        assert roofline.model_flops_decode(cfg, gb, t) == \
            jroofline.model_flops_decode(jcfg, gb, t)


def test_production_team_and_ctx():
    """16 x 16 (data, model) and 2 x 16 x 16 (pod, data, model) as stacked
    teams; ``make_ctx`` takes the last axis as TP, the rest as DP, with
    the reference's defaults (sp, remat, bf16 parameters and compute)."""
    single, multi = mesh.make_production_team(), \
        mesh.make_production_team(multi_pod=True)
    assert (single.axes, single.sizes) == (("data", "model"), (16, 16))
    assert (multi.axes, multi.sizes) == (("pod", "data", "model"),
                                         (2, 16, 16))
    assert (mesh.team_name(single), mesh.team_name(multi)) == \
        ("16x16", "2x16x16")
    ctx = mesh.make_ctx(multi, backend="posh")
    assert (ctx.tp_size, ctx.dp_size, ctx.dp_axes) == \
        (16, 32, ("pod", "data"))
    assert ctx.sp and ctx.remat and ctx.backend == "posh"
    assert ctx.param_dtype == ctx.compute_dtype == torch.bfloat16
    ctx = mesh.make_ctx(TEAM, param_dtype=torch.float32, remat=False)
    assert (ctx.tp_size, ctx.dp_size, ctx.remat) == (4, 2, False)
    assert ctx.param_dtype == torch.float32


def test_roofline_terms_and_collective_bytes():
    """H100 SXM data-sheet rates; each call's received bytes from the
    communicators' records (the output buffer), identity calls none."""
    from repro_torch.comm import make_communicator
    assert (roofline.HBM_BW, roofline.LINK_BW) == (3.35e12, 450e9)
    assert roofline.PEAK_FLOPS == {torch.bfloat16: 989e12,
                                   torch.float32: 67e12}
    t = roofline.terms(989e12, 3.35e12, 450e9 * 2, torch.bfloat16)
    assert (t["compute_s"], t["memory_s"], t["collective_s"]) == \
        (1.0, 1.0, 2.0) and t["dominant"] == "collective"
    c = make_communicator("model", size=4, backend="posh")
    one = make_communicator("data", size=1, backend="posh")
    x = torch.ones(4, 8)                        # 32 bytes a PE
    c.psum(x)
    c.all_gather(x, axis=0)
    c.psum_scatter(x, axis=0)
    one.psum(torch.ones(1, 8))
    total, counts = roofline.collective_bytes([c, one, c])
    assert dict(counts) == {"psum": 1, "psum_bytes": 32, "all_gather": 1,
                            "all_gather_bytes": 128, "psum_scatter": 1,
                            "psum_scatter_bytes": 8}
    assert total == 32 + 128 + 8


def test_meta_inputs_allocate_nothing():
    cfg = configs.get("llama-3.2-vision-90b")
    b = shapes.train_inputs(cfg, "train_4k")
    assert b["tokens"].shape == (256, 4097) and b["tokens"].is_meta
    assert b["img_embeds"].shape == (256, cfg.img_tokens, cfg.d_model)
    assert b["img_embeds"].dtype == torch.bfloat16
    w = configs.get("whisper-base")
    p = shapes.prefill_inputs(w, "prefill_32k")
    assert p["frames"].shape == (32, w.enc_frames, w.d_model)
    assert shapes.decode_batch_info(cfg, mesh.make_production_team(),
                                    "decode_32k") == (8, 32768, False)
    assert shapes.decode_batch_info(cfg, mesh.make_production_team(),
                                    "long_500k") == (1, 524288, True)


# ----------------------------------------------------------------------
# the dry run: one smoke cell a family on a (2, 4) team
# ----------------------------------------------------------------------
class _Products(TorchDispatchMode):
    """2 m n k over every matrix product dispatched (an independent tally
    of what FlopCounterMode counts)."""

    OPS = {"mm", "bmm", "addmm", "baddbmm"}

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.OPS:
            a, b = (args[1], args[2]) if name in ("addmm", "baddbmm") \
                else (args[0], args[1])
            batch = a.shape[0] if a.dim() == 3 else 1
            self.flops += 2 * batch * a.shape[-2] * a.shape[-1] * b.shape[-1]
        return func(*args, **(kwargs or {}))


def _attn_proj(cfg, n, tp):
    """q, o and the per-PE K/V projections of n tokens (K/V heads
    replicated to the PEs that read them when n_kv < tp)."""
    d, hd = cfg.d_model, cfg.n_heads * cfg.head_dim
    kv = tp * cfg.kv_per_rank(tp) * cfg.head_dim
    return 2 * n * (2 * d * hd + 2 * d * kv)


def _mlp(cfg, n, ff=None):
    mats = 3 if cfg.act in ("swiglu", "geglu") else 2
    return 2 * n * mats * cfg.d_model * (ff or cfg.d_ff)


def _analytic(cfg, rows, seq, tp):
    """Closed-form matrix-product FLOPs of a prefill of rows x seq on a
    TP group of tp (summed over its PEs)."""
    n = rows * seq
    if cfg.family == "dense":
        return cfg.n_layers * (_attn_proj(cfg, n, tp) + _mlp(cfg, n))
    if cfg.family == "moe":
        m = cfg.moe
        ep = m.experts_padded(1)
        cap = int(n * m.top_k * m.capacity_factor / ep) + 1
        experts = 2 * ep * cap * 3 * cfg.d_model * m.expert_ff
        router = tp * 2 * n * cfg.d_model * ep
        shared = _mlp(cfg, n, m.shared_ff) if m.shared_ff else 0
        return cfg.n_layers * (_attn_proj(cfg, n, tp) + router + experts
                               + shared)
    if cfg.family == "vlm":
        ng = cfg.n_layers // cfg.cross_attn_every
        dense = (cfg.n_layers - ng) * (_attn_proj(cfg, n, tp) + _mlp(cfg, n))
        hd = cfg.n_heads * cfg.head_dim
        kv = tp * cfg.kv_per_rank(tp) * cfg.head_dim
        cross = 2 * n * 2 * cfg.d_model * hd \
            + 2 * rows * cfg.img_tokens * 2 * cfg.d_model * kv + _mlp(cfg, n)
        return dense + ng * cross
    if cfg.family == "encdec":
        ne = rows * cfg.enc_frames
        hd = cfg.n_heads * cfg.head_dim
        enc = _attn_proj(cfg, ne, tp) + _mlp(cfg, ne)
        dec = _attn_proj(cfg, n, tp) + 2 * n * 2 * cfg.d_model * hd \
            + 2 * ne * 2 * cfg.d_model * tp * cfg.kv_per_rank(tp) \
            * cfg.head_dim + _mlp(cfg, n)
        return cfg.enc_layers * enc + cfg.n_layers * dec
    if cfg.family == "ssm":
        return cfg.n_layers * _rwkv_layer(cfg, rows, seq, tp)
    if cfg.family == "hybrid":
        k = cfg.shared_attn_every
        shared = _attn_proj(cfg, n, tp) + _mlp(cfg, n)
        return cfg.n_layers * _mamba_layer(cfg, rows, seq, tp) \
            + (cfg.n_layers // k) * shared
    raise AssertionError(cfg.family)


def _rwkv_layer(cfg, b, t, tp):
    """RWKV6 at tp: the token-shift and decay LoRAs replicated on every
    PE, r / k / v / g / the decay's second LoRA / o split by heads, the
    chunked WKV (two C x C products and two dh x dh ones a chunk a head),
    the channel mix split by d_ff with its receptance on each PE's own
    rows."""
    from repro_torch.models.rwkv import CHUNK, DECAY_LORA_R, LORA_R
    d, dh, ff, n = cfg.d_model, cfg.rwkv_head_dim, cfg.d_ff, b * t
    hp = cfg.rwkv_padded_heads or cfg.n_heads
    da = hp * dh
    loras = tp * 2 * n * (2 * d * 5 * LORA_R + d * DECAY_LORA_R)
    proj = 2 * n * (4 * d * da + DECAY_LORA_R * da + da * d)
    wkv = 2 * b * (t // CHUNK) * hp * (2 * CHUNK ** 2 * dh
                                       + 2 * CHUNK * dh ** 2)
    chan = 2 * n * (2 * d * ff + d * d)
    return loras + proj + wkv + chan


def _mamba_layer(cfg, b, t, tp):
    """Mamba2 at tp on the sequence padded to its chunk: z / x / dt / o
    split by SSD heads, B and C replicated on every PE, and the chunked
    SSD (C B^T on every PE, then its heads' products)."""
    from repro_torch.models.ssm import CHUNK, HEAD_DIM
    d, ds = cfg.d_model, cfg.ssm_state
    d_in = cfg.ssm_expand * d
    nh, tpad = d_in // HEAD_DIM, -(-t // CHUNK) * CHUNK
    npad, nc, hl = b * tpad, tpad // CHUNK, d_in // HEAD_DIM // tp
    proj = 2 * npad * d * (2 * d_in + nh) + 2 * npad * d_in * d \
        + tp * 2 * npad * d * 2 * ds
    ssd = tp * b * nc * 2 * CHUNK * (CHUNK * ds + CHUNK * hl * HEAD_DIM
                                     + 2 * hl * HEAD_DIM * ds)
    return proj + ssd


FAMILIES = {"dense": "qwen3-8b", "moe": "qwen3-moe-30b-a3b",
            "ssm": "rwkv6-3b", "hybrid": "zamba2-7b",
            "encdec": "whisper-base", "vlm": "llama-3.2-vision-90b"}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_dry_run_prefill_cell_matches_an_analytic_count(family):
    arch = FAMILIES[family]
    cfg = configs.get_smoke(arch)
    assert cfg.family == family
    tally = _Products()
    with tally:
        r = dryrun.lower_cell(arch, "prefill_32k", team=TEAM, smoke=True,
                              global_batch=ROWS, seq=cfg.max_seq,
                              verbose=False)
    assert r["status"] == "ok" and r["mesh"] == "2x4"
    rows = ROWS // 2                              # one DP replica's rows
    assert r["matmul_flops"] == _analytic(cfg, rows, cfg.max_seq, TP)
    assert r["matmul_flops"] == tally.flops
    assert r["flops_dev"] == (r["matmul_flops"] + r["kernel_flops"]) / TP
    assert r["pes_run"] == TP and r["peak_gib_card"] > r["arg_gib_dev"] * TP
    if family == "dense":                 # causal T = S: T (T + 1) / 2 pairs
        t = cfg.max_seq
        assert r["kernel_flops"] == cfg.n_layers * 4 * cfg.head_dim \
            * cfg.n_heads * rows * t * (t + 1) // 2
        assert r["flash_calls"] == cfg.n_layers
    if TP > 1 and family != "ssm":
        assert r["coll_bytes_dev"] > 0


def test_dry_run_train_and_decode_cells():
    """A train step (every DP replica, remat, ZeRO-1, both microbatches)
    and a decode step on meta: the flash kernel's meta calls are one a
    layer a microbatch a replica, twice under remat, and the training
    step moves gradients through the DP communicator."""
    cfg = configs.get_smoke("qwen3-8b")
    r = dryrun.lower_cell("qwen3-8b", "train_4k", team=TEAM, smoke=True,
                          global_batch=8, seq=cfg.max_seq, microbatches=2,
                          verbose=False)
    assert r["flash_calls"] == cfg.n_layers * 2 * 2 * 2
    assert r["pes_run"] == 8 and r["matmul_flops"] > 0
    assert {"psum_scatter", "all_gather"} <= set(r["coll_counts"])
    assert r["peak_gib_card"] > 0 and r["dominant"] in (
        "compute", "memory", "collective")
    d = dryrun.lower_cell("rwkv6-3b", "decode_32k", team=TEAM, smoke=True,
                          verbose=False)
    assert d["status"] == "ok" and d["flash_calls"] == 0
    assert d["matmul_flops"] > 0
    skip = dryrun.lower_cell("qwen3-8b", "long_500k", smoke=True,
                             verbose=False)
    assert skip["status"] == "skip"
    with pytest.raises(ValueError, match="xla and posh"):
        dryrun.lower_cell("qwen3-8b", "train_4k", backend="pallas",
                          smoke=True)
    with pytest.raises(ValueError, match="not a model"):
        dryrun.lower_cell("posh-micro", "train_4k")


@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16])
def test_dry_run_per_pe_peak_does_not_shrink_with_replicas(param_dtype):
    """One PE of a DP 2 x TP 2 team holds what one of a TP 2 group holds
    on half the batch under zero-0 (its parameters, optimizer state,
    gradient row and one replica's activations are the same), though the
    stacked pass holds two replicas' rows on one card; zero-1 takes each
    PE's share of the optimizer state off."""
    cfg = configs.get_smoke("qwen3-8b")

    def cell(dp, zero):
        return dryrun.lower_cell(
            "qwen3-8b", "train_4k", team=Team(("data", "model"), (dp, 2)),
            smoke=True, global_batch=4 * dp, seq=cfg.max_seq,
            microbatches=2, zero=zero, param_dtype=param_dtype,
            verbose=False)
    one, two = cell(1, 0), cell(2, 0)
    assert two["arg_gib_dev"] == one["arg_gib_dev"]
    assert two["peak_gib_dev"] == pytest.approx(one["peak_gib_dev"],
                                                rel=1e-3)
    assert two["peak_gib_card"] > one["peak_gib_card"]
    z1 = cell(2, 1)
    assert z1["arg_gib_dev"] < two["arg_gib_dev"]


# ----------------------------------------------------------------------
# the flash kernel's meta route
# ----------------------------------------------------------------------
@pytest.mark.parametrize("case", [
    dict(b=2, h=4, hkv=2, t=48, s=48, d=32, kw=dict(causal=True)),
    dict(b=1, h=2, hkv=1, t=40, s=64, d=16,
         kw=dict(causal=False, window=None)),
    dict(b=4, h=2, hkv=2, t=16, s=64, d=16,
         kw=dict(causal=True, q_offset=3, pe_rows=2, pe_stride=16)),
    dict(b=1, h=1, hkv=1, t=50, s=50, d=8,
         kw=dict(causal=True, window=7, kv_len=45)),
], ids=["causal", "noncausal", "per_pe", "window"])
def test_flash_meta_route(case):
    """Outputs of the kernel's shapes and dtypes, no launch, and the
    operation count the masks leave — held to a brute-force count of
    the plain version's mask on the CPU."""
    b, h, hkv, t, s, d, kw = (case[k] for k in
                              ("b", "h", "hkv", "t", "s", "d", "kw"))
    q = torch.empty(b, h, t, d, device="meta", dtype=torch.bfloat16)
    k = torch.empty(b, hkv, s, d, device="meta", dtype=torch.bfloat16)
    fa.reset_meta()
    launches = fa.LAUNCHES["flash_attention"]
    out, lse = fa.flash_attention(q, k, k, **kw)
    assert out.shape == q.shape and out.dtype == q.dtype and out.is_meta
    assert lse.shape == (b, h, t) and lse.dtype == torch.float32
    assert fa.LAUNCHES["flash_attention"] == launches
    pos = fa.query_positions(kw.get("q_offset", 0), t, "cpu", b,
                             kw.get("pe_rows", 1), kw.get("pe_stride", 0))
    mask = fa.attention_mask(pos, torch.arange(s), kw.get("causal", True),
                             kw.get("window"), kw.get("kv_len", s))
    pairs = int(mask.expand(b, t, s).sum()) * h
    assert fa.META == {"calls": 1, "flops": 4 * d * pairs,
                       "bytes": (2 * q.numel() + 2 * k.numel()) * 2
                       + b * h * t * 4}
    with pytest.raises(ValueError, match="H % H_kv"):
        fa.flash_attention(q, k[:, :1].expand(b, 3, s, d), k[:, :1].expand(
            b, 3, s, d))


class _Elsewhere(torch.Tensor):
    """A tensor that reports a device with no route."""

    @property
    def device(self):
        return torch.device("xpu")


def test_flash_has_no_route_but_meta_cpu_and_cuda():
    q = torch.Tensor._make_subclass(_Elsewhere, torch.zeros(1, 1, 4, 8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention(q, q, q)
    cpu = torch.randn(1, 2, 4, 8)
    out, lse = fa.flash_attention(cpu, cpu, cpu)         # the plain version
    ref, ref_lse = fa.flash_attention_ref(cpu, cpu, cpu)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    assert math.isfinite(float(np.asarray(lse).sum()))


def test_bf16_parameters_fold_microbatch_gradients_into_f32_rows():
    """The dry run's default ctx (bf16 parameters) trains: each
    microbatch's bf16 gradient is added into the f32 gradient row, as the
    reference's microbatch scan accumulates, and the step updates the
    bf16 parameters through their f32 masters."""
    from repro_torch.data import SyntheticLM
    from repro_torch.models import lm, registry
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.grad import _pairs, replica_grads
    from repro_torch.train.step import train_state_from
    from repro_torch.train.tree import leaves

    cfg = configs.get_smoke("qwen3-8b")
    ctx = mesh.make_ctx(Team(("data", "model"), (1, 1)), remat=False)
    api = registry.build(cfg)
    params = lm.init(torch.Generator().manual_seed(0), cfg,
                     dtype=torch.bfloat16)
    state = train_state_from(params, ctx, AdamWConfig(), cfg)
    batch = SyntheticLM(vocab=cfg.vocab, seq_len=16,
                        global_batch=4).batch(0, device="cpu")
    _, rows = replica_grads(api.loss_fn, state["params"], batch, ctx, cfg,
                            microbatches=2)
    ps = [p for p, _ in _pairs(state["params"], rows, 0)]
    want = [torch.zeros(p.shape) for p in ps]
    for half in (batch["tokens"][:2], batch["tokens"][2:]):
        loss = api.loss_fn(state["params"], {"tokens": half}, ctx, cfg,
                           for_grad=True)
        for w, g in zip(want, torch.autograd.grad(loss.sum(), ps)):
            w.add_(g)
    for (p, slot), w in zip(_pairs(state["params"], rows, 0), want):
        assert slot.dtype == torch.float32 and p.dtype == torch.bfloat16
        assert torch.equal(slot, w / 2)
    before = [p.detach().clone() for p in leaves(state["params"])]
    step = make_train_step(cfg, ctx, api, AdamWConfig())
    state, m = step(state, batch)
    assert np.isfinite(float(m["loss"]))
    assert any(not torch.equal(a, b) for a, b in
               zip(before, leaves(state["params"])))
