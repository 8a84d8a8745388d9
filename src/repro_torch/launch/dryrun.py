"""Dry run of a (arch x shape x team) cell on the meta device: FLOPs,
bytes, collective bytes and peak memory of one step, and its roofline
terms on the H100 (counterpart of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
        --shape train_4k [--multi-pod] [--backend xla|posh] [--json out]

needs no GPU.  The step runs ONCE, at full depth, on ``device="meta"``
(tensors with shapes and dtypes and no storage) on the production team
(``launch.mesh``: 16 x 16, or 2 x 16 x 16), the port's stacked team —
every PE's shard on one tensor's leading axis:

  * ``train``: ``train.make_train_step`` with AdamW and ZeRO
    (``--zero``), the global batch in ``shapes.microbatches_for``
    microbatches, every DP replica in turn, its collectives through the
    ctx's communicators;
  * ``prefill``: one DP replica's rows (the replicas share nothing);
  * ``decode``: one step of one DP replica's rows at the last position
    of a full cache.

What is counted, over the whole pass:

  * FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (the matrix
    products, forward and backward, as PyTorch counts them; elementwise
    work is not counted) plus the hand kernels' own counts — the flash
    kernel's meta route (``kernels.flash_attention.META``);
  * bytes: each op's inputs plus its outputs (views and allocations
    excluded), plus the flash kernel's;
  * collective bytes: the communicators' calls by kind and payload
    (``roofline.collective_bytes``);
  * peak: the live bytes of distinct storages, tracked over the pass
    (a weak reference on each storage, so autograd's saved tensors
    count until autograd frees them), the state and inputs included.

The per-PE figures (``*_dev``) are the pass's divided by the PEs it ran
— the whole team for a training step, the one TP group of a prefill or
a decode step — exact for FLOPs and bytes of work every PE shares
alike.  The per-PE peak is the most that one PE of a real team holds at
once: each live storage counts by its layout on the stacked team — over
the TP group (``/ tp``: the parameters, zero-0's optimizer state, and
what a replica's forward and backward make, ``train.grad.backward``
running one replica at a time), over the whole team (``/ dp tp``: the
stacked gradient rows, zero-1's chunks, and what the DP reduction and
the update make) or over the replicas (``/ dp``: the global batch).
``peak_gib_card`` is the live bytes of the whole stacked pass on one
card, ``useful_ratio`` the model FLOPs over the per-PE FLOPs times the
team's PEs.

The reference lowers and compiles the step with XLA and reads
``cost_analysis()``; XLA counts a scan body once, so it lowers two
reduced depths and extrapolates (``_depth_points``).  The port's layer
loop is a Python loop, and the meta pass runs every layer of every
microbatch: its counts are whole and need no extrapolation, and the
reference's ``--single`` (its accounting-only pass) has no counterpart.
What meta cannot tell: any time (the roofline terms are bounds from data-sheet
rates), the allocator's fragmentation and the CUDA context, or work
that depends on values (a meta MoE router routes nothing: the einsum
dispatch's capacity buffers are computed in full, as the reference's
compiled program does).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import roofline, shapes
from repro_torch.launch.mesh import (make_ctx, make_production_team,
                                     team_name)
from repro_torch.models import registry

META = torch.device("meta")
# ops that allocate or alias and move no bytes
_NO_BYTES = ("empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "detach", "lift_fresh", "alias")


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Probe(TorchDispatchMode):
    """Bytes of every op, and the live bytes of distinct storages: the
    card's (``live`` / ``peak``) and one PE's (``live_pe`` / ``peak_pe``),
    each storage counted there over the PEs that share it (``share``: the
    count given to ``track``, else the one set for storages made now)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = self.peak = 0
        self.live_pe = self.peak_pe = 0.0
        self.share = 1
        self._refs: dict = {}

    def track(self, t: torch.Tensor, share: int | None = None) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._refs:
            return
        n = st.nbytes()
        pe = n / (share or self.share)

        def gone(_, key=key, n=n, pe=pe):
            self._refs.pop(key, None)
            self.live -= n
            self.live_pe -= pe

        self._refs[key] = weakref.ref(st, gone)
        self.live += n
        self.live_pe += pe
        self.peak = max(self.peak, self.live)
        self.peak_pe = max(self.peak_pe, self.live_pe)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = _tensors(out)
        for t in outs:
            self.track(t)
        name = func.overloadpacket.__name__
        if not func.is_view and name not in _NO_BYTES:
            self.bytes += sum(_nbytes(t) for t in
                              _tensors(list(args) + list((kwargs or {})
                                                         .values())) + outs)
        return out


def _cfg(arch, smoke, pad_heads):
    cfg = configs.get_smoke(arch) if smoke else configs.get(arch)
    registry.require_model(cfg)
    if pad_heads:
        cfg = dataclasses.replace(cfg, n_heads=pad_heads)
    return cfg


def _params(cfg, ctx, api):
    """Global parameters on meta in the TP layout."""
    from repro_torch.weights import shard_for_tp
    p = api.init(torch.Generator(), cfg, dtype=ctx.param_dtype,
                 tp=ctx.tp_size, device=META)
    return shard_for_tp(p, cfg, ctx.tp_size)


def _train(cfg, ctx, api, shape_name, zero, mb, gb, seq):
    from repro_torch.train import (AdamWConfig, init_train_state,
                                   make_train_step)
    opt = AdamWConfig(zero=zero)
    state = init_train_state(torch.Generator(), cfg, ctx, api, opt,
                             device=META)
    step = make_train_step(cfg, ctx, api, opt, microbatches=mb)
    batch = shapes.train_inputs(cfg, shape_name, global_batch=gb, seq=seq,
                                dtype=ctx.compute_dtype)
    tp, dp = ctx.tp_size, ctx.dp_size
    resident = [(state["params"], tp), (state["opt"], dp * tp if zero
                                        else tp), (batch, dp)]
    return resident, lambda: step(state, batch)


@contextlib.contextmanager
def _replica_share(probe: Probe, share: int):
    """Storages made inside ``train.grad.backward`` (one replica's
    forward and backward) count over ``share`` PEs, the TP group."""
    from repro_torch.train import grad
    inner = grad.backward

    def backward(*args, **kw):
        outer, probe.share = probe.share, share
        try:
            return inner(*args, **kw)
        finally:
            probe.share = outer

    grad.backward = backward
    try:
        yield
    finally:
        grad.backward = inner


def _prefill(cfg, ctx, api, team, shape_name, gb, seq):
    from repro_torch.models import encdec
    from repro_torch.parallel import sp_gather
    gb = gb or shapes.SHAPES[shape_name]["global_batch"]
    rows = max(1, gb // shapes.dp_size_of(team))
    batch = shapes.prefill_inputs(cfg, shape_name, global_batch=rows,
                                  seq=seq, dtype=ctx.compute_dtype)
    params = _params(cfg, ctx, api)

    def run():
        with torch.no_grad():
            if cfg.family == "encdec":
                enc = encdec.encode(params, batch["frames"], ctx, cfg)
                x = encdec.decode_train(params, batch["tokens"], enc, ctx,
                                        cfg)
                return sp_gather(x, ctx)[..., -1, :]
            return api.prefill(params, batch["tokens"], ctx, cfg,
                               img_embeds=batch.get("img_embeds"))
    return (params, batch), run


def _decode(cfg, ctx, api, team, shape_name):
    from repro_torch.models import encdec, lm
    from repro_torch.models.attention import cross_kv
    b, max_len, _ = shapes.decode_batch_info(cfg, team, shape_name)
    params = _params(cfg, ctx, api)
    state = api.init_decode_state(cfg, ctx, b, max_len, device=META)
    state["pos"] = max_len - 1          # one token against a full cache
    token = torch.zeros((b,), dtype=torch.int32, device=META)
    side = shapes.side_inputs(cfg, b, ctx.compute_dtype)
    with torch.no_grad():
        if cfg.family == "encdec":
            enc = encdec.encode(params, side["frames"], ctx, cfg)
            extra = encdec.encoder_cross_kv(params, enc, ctx, cfg)
        elif cfg.family == "vlm":
            img = lm.per_pe(side["img_embeds"], ctx)
            kvs = [cross_kv(lm.layer(params["cross"], g)["xattn"], img, ctx,
                            cfg)
                   for g in range(cfg.n_layers // cfg.cross_attn_every)]
            extra = (torch.stack([k for k, _ in kvs]),
                     torch.stack([v for _, v in kvs]))
        else:
            extra = None

    def run():
        with torch.no_grad():
            if cfg.family == "encdec":
                return api.decode_step(params, token, state, extra, ctx, cfg)
            return api.decode_step(params, token, state, ctx, cfg,
                                   img_kv=extra)
    return (params, state, extra), run


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               backend: str = "xla", ce_mode: str = "vocab_parallel",
               moe_dispatch: str = "einsum", zero: int = 1,
               microbatches: int | None = None, verbose: bool = True,
               pad_heads: int | None = None, team=None, smoke: bool = False,
               global_batch: int | None = None, seq: int | None = None,
               **ctx_overrides) -> dict:
    """Run the cell's step once on meta and count it (module docstring).
    ``team`` (a ``Team``; default the production one), ``smoke`` (the
    reduced config), ``global_batch`` / ``seq`` (other sizes than
    ``shapes.SHAPES``'s) and ``ctx_overrides`` (any ``ParallelCtx``
    field, e.g. ``param_dtype``) are the port's, for tests and for
    checking the count against a run on the card."""
    if backend not in ("xla", "posh"):
        raise ValueError(f"the dry run takes backends xla and posh, as the "
                         f"reference's; got {backend!r}")
    cfg = _cfg(arch, smoke, pad_heads)
    team = team or make_production_team(multi_pod=multi_pod)
    mesh = team_name(team)
    ok, why = shapes.runs_shape(cfg, shape_name)
    if not ok:
        res = {"arch": arch, "shape": shape_name, "mesh": mesh,
               "status": "skip", "why": why}
        if verbose:
            print(json.dumps(res))
        return res
    info = dict(shapes.SHAPES[shape_name])
    info["global_batch"] = global_batch or info["global_batch"]
    info["seq"] = seq or info["seq"]
    kind = info["kind"]
    ctx = make_ctx(team, backend=backend, ce_mode=ce_mode,
                   moe_dispatch=moe_dispatch, **ctx_overrides)
    api = registry.build(cfg)
    n_dev = team.size()
    t0 = time.monotonic()
    if kind == "train":
        mb = microbatches or shapes.microbatches_for(arch)
        resident, run = _train(cfg, ctx, api, shape_name, zero, mb,
                               global_batch, seq)
    elif kind == "prefill":
        resident, run = _prefill(cfg, ctx, api, team, shape_name,
                                 global_batch, seq)
    else:
        resident, run = _decode(cfg, ctx, api, team, shape_name)
    t_setup = time.monotonic() - t0
    for c in (ctx.tp_comm, ctx.dp_comm):
        c.reset_stats()
    fa.reset_meta()
    probe = Probe()
    if kind != "train":
        resident = [(resident, ctx.tp_size)]
    for tree, share in resident:
        for t in _tensors(tree):
            probe.track(t, share)
    arg_pe = probe.live_pe
    probe.share = n_dev if kind == "train" else ctx.tp_size
    replica = (_replica_share(probe, ctx.tp_size) if kind == "train"
               else contextlib.nullcontext())
    t0 = time.monotonic()
    with FlopCounterMode(display=False) as counter, probe, replica:
        out = run()
    t_run = time.monotonic() - t0
    del out
    coll_b, counts = roofline.collective_bytes((ctx.tp_comm, ctx.dp_comm))
    flops = counter.get_total_flops() + fa.META["flops"]
    nbytes = probe.bytes + fa.META["bytes"]
    ran = n_dev if kind == "train" else ctx.tp_size    # the PEs it ran
    flops_dev, bytes_dev = flops / ran, nbytes / ran
    rt = roofline.terms(flops_dev, bytes_dev, float(coll_b),
                        ctx.compute_dtype)
    mf = roofline.model_flops(cfg, kind, info)
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh,
        "backend": backend, "status": "ok", "device": "meta",
        "rates": "H100 SXM data sheet", "n_pe": n_dev, "pes_run": ran,
        "t_setup_s": round(t_setup, 2), "t_run_s": round(t_run, 2),
        "flops_dev": flops_dev, "bytes_dev": bytes_dev,
        "coll_bytes_dev": float(coll_b),
        "compute_ms": rt["compute_s"] * 1e3,
        "memory_ms": rt["memory_s"] * 1e3,
        "collective_ms": rt["collective_s"] * 1e3,
        "dominant": rt["dominant"], "model_flops": mf,
        "useful_ratio": mf / max(flops_dev * n_dev, 1.0),
        "matmul_flops": counter.get_total_flops(),
        "kernel_flops": fa.META["flops"],
        "flash_calls": fa.META["calls"],
        "peak_gib_card": probe.peak / 2**30,
        "peak_gib_dev": probe.peak_pe / 2**30,
        "temp_gib_dev": (probe.peak_pe - arg_pe) / 2**30,
        "arg_gib_dev": arg_pe / 2**30,
        "coll_counts": dict(counts),
    }
    if verbose:
        print(json.dumps({k: v for k, v in result.items()
                          if k != "coll_counts"}))
        print("  collectives:", dict(counts))
    return result


def run_cell(arch, shape_name, **kw) -> dict:
    """The reference's name for a whole cell: here the one full-depth
    pass of ``lower_cell`` (no depth extrapolation)."""
    return lower_cell(arch, shape_name, **kw)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(shapes.SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--backend", default="xla", choices=["xla", "posh"])
    ap.add_argument("--ce-mode", default="vocab_parallel",
                    choices=["vocab_parallel", "gathered"])
    ap.add_argument("--moe-dispatch", default="einsum",
                    choices=["einsum", "alltoall"])
    ap.add_argument("--zero", type=int, default=1, choices=[0, 1])
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--json", default=None, help="append result JSONL here")
    ap.add_argument("--pad-heads", type=int, default=None,
                    help="pad query heads to this count (zero-padded heads "
                         "are function-preserving; switches ctx->head "
                         "attention layout when divisible by TP)")
    args = ap.parse_args(argv)
    res = run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                   backend=args.backend, ce_mode=args.ce_mode,
                   moe_dispatch=args.moe_dispatch, zero=args.zero,
                   microbatches=args.microbatches, pad_heads=args.pad_heads)
    if args.json:
        with open(args.json, "a") as f:
            f.write(json.dumps(res) + "\n")
    return res


if __name__ == "__main__":
    main()
