#!/usr/bin/env python3
"""CPU numbers behind the RWKV / Mamba-hybrid slice's tolerances and its
op counts: the port (f32 and f64) against the JAX reference (f32) at the
smoke configs, and the ATen ops the new layers issue.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/a10_numerics.py

Prints, for rwkv6-3b and zamba2-7b (smoke): each gradient leaf's largest
distance from the port's f64 run, for the port's f32 and the reference's
f32 gradients, as a share of the leaf's largest f64 gradient; the 3-step
grad norms of the reference (f32, in 1 and in 2 microbatches), the port
(f32) and the port in f64 (clip 1.0 and AdamW by hand, lr 5e-3, 4 rows
of SyntheticLM); after the 3 steps, per parameter leaf, the port's
distance from the reference and the reference's 2-microbatch run's, as
shares of the reference's own movement from the start (2-norms; and the
largest element distance over the largest element movement); then the
ATen ops (views excluded) of one layer's forward and of one decode token
per layer, counted by a dispatch mode — counts of work issued, not
times.  The f64 runs are the port's, in f64 through the recurrences'
f32 casts: a yardstick of f32 rounding, not a reference.
"""
from __future__ import annotations

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jconfigs
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import registry as jregistry
from repro.parallel.ctx import ParallelCtx as JCtx
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.optimizer import adamw_init as jadamw_init
from repro.train.step import make_train_step as jmake_train_step
from repro_torch import configs
from repro_torch.data import SyntheticLM
from repro_torch.models import lm, registry
from repro_torch.parallel import ParallelCtx
from repro_torch.train import AdamWConfig, make_train_step
from repro_torch.train import grad as tgrad
from repro_torch.train import tree
from repro_torch.train.step import train_state_from
from repro_torch.weights import from_jax

LR, BATCH, STEPS = 5e-3, 4, 3
JCTX = JCtx(dp_size=1, tp_size=1, sp=False, remat=True,
            param_dtype=jnp.float32, compute_dtype=jnp.float32)
VIEWS = {"view", "_unsafe_view", "slice", "select", "expand", "t",
         "transpose", "permute", "as_strided", "detach", "alias",
         "unsqueeze", "squeeze", "reshape", "split", "unbind", "lift_fresh"}


@contextlib.contextmanager
def f64_casts():
    cast = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **k: (
        self if self.dtype == torch.float64 else cast(self, *a, **k))
    try:
        yield
    finally:
        torch.Tensor.float = cast


def ctx_of(dtype):
    return ParallelCtx(remat=False, param_dtype=dtype, compute_dtype=dtype)


def node(tree_, path):
    for k in path:
        tree_ = tree_[k.key]
    return tree_


def reference_steps(cfg, api, params, microbatches):
    data = JSyntheticLM(vocab=cfg.vocab, seq_len=cfg.max_seq,
                        global_batch=BATCH)
    opt = JAdamWConfig(lr=LR)
    state = {"params": params, "opt": jadamw_init(params, JCTX, opt),
             "step": jnp.zeros((), jnp.int32)}
    fn = jax.jit(jmake_train_step(cfg, JCTX, api, opt,
                                  microbatches=microbatches))
    norms = []
    for s in range(STEPS):
        state, m = fn(state, data.batch(s))
        norms.append(float(m["grad_norm"]))
    return norms, jax.tree.map(np.asarray, state["params"])


def reference(arch):
    cfg = jconfigs.get_smoke(arch)
    api = jregistry.build(cfg)
    params = api.init(jax.random.PRNGKey(0), cfg, JCTX)
    data = JSyntheticLM(vocab=cfg.vocab, seq_len=cfg.max_seq,
                        global_batch=BATCH)
    _, grads = jax.jit(jax.value_and_grad(
        lambda p, b: api.loss_fn(p, b, JCTX, cfg)))(params, data.batch(0))
    norms, final = reference_steps(cfg, api, params, 1)
    norms2, final2 = reference_steps(cfg, api, params, 2)
    return (jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, grads),
            norms, final, norms2, final2)


def port_grads(cfg, params_np, dtype):
    params = tgrad.trainable(tree.tree_map(lambda t: t.to(dtype),
                                           from_jax(params_np)))
    data = SyntheticLM(vocab=cfg.vocab, seq_len=cfg.max_seq,
                       global_batch=BATCH)
    lm.loss_fn(params, data.batch(0, device="cpu"), ctx_of(dtype),
               cfg).backward()
    return params


def port_steps_f32(cfg, params_np):
    opt = AdamWConfig(lr=LR)
    ctx = ParallelCtx(remat=True, param_dtype=torch.float32,
                      compute_dtype=torch.float32)
    state = train_state_from(from_jax(params_np), ctx, opt)
    step = make_train_step(cfg, ctx, registry.build(cfg), opt)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=cfg.max_seq,
                       global_batch=BATCH)
    norms = [float(step(state, data.batch(s, device="cpu"))[1]["grad_norm"])
             for s in range(STEPS)]
    return norms, lm.unstack(state["params"])


def port_steps_f64(cfg, params_np):
    """The 3 steps' grad norms in f64: the port's loss and gradients,
    then the reference's clip (1.0) and AdamW by hand."""
    f64 = torch.float64
    params = tgrad.trainable(tree.tree_map(lambda t: t.to(f64),
                                           lm.unstack(from_jax(params_np))))
    ps = tree.leaves(params)
    m = [torch.zeros_like(p) for p in ps]
    v = [torch.zeros_like(p) for p in ps]
    o = AdamWConfig(lr=LR)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=cfg.max_seq,
                       global_batch=BATCH)
    norms = []
    for s in range(STEPS):
        for p in ps:
            p.grad = None
        lm.loss_fn(params, data.batch(s, device="cpu"), ctx_of(f64),
                   cfg).backward()
        with torch.no_grad():
            gn = float(torch.sqrt(sum((p.grad ** 2).sum() for p in ps)))
            norms.append(gn)
            scale = min(1.0, 1.0 / gn)
            bc1, bc2 = 1 - o.b1 ** (s + 1), 1 - o.b2 ** (s + 1)
            for p, mi, vi in zip(ps, m, v):
                g = p.grad * scale
                mi.mul_(o.b1).add_(g, alpha=1 - o.b1)
                vi.mul_(o.b2).addcmul_(g, g, value=1 - o.b2)
                p.sub_(o.lr * ((mi / bc1) / ((vi / bc2).sqrt() + o.eps)
                               + o.weight_decay * p))
    return norms


def stacked(params):
    def st(items):
        if isinstance(items[0], dict):
            return {k: st([it[k] for it in items]) for k in items[0]}
        return torch.stack([it.detach() for it in items])
    return {k: st(v) if isinstance(v, list) else v for k, v in params.items()}


def numerics(arch):
    cfg = configs.get_smoke(arch)
    params0, jgrads, jnorms, jfinal, jnorms2, jfinal2 = reference(arch)
    g32 = port_grads(cfg, params0, torch.float32)
    with f64_casts():
        g64 = port_grads(cfg, params0, torch.float64)
    worst_port, worst_ref = 0.0, 0.0
    for path, want in jax.tree_util.tree_flatten_with_path(jgrads)[0]:
        x64 = node(g64, path).grad.numpy()
        big = float(np.abs(x64).max()) or 1.0
        worst_port = max(worst_port, float(np.abs(
            node(g32, path).grad.double().numpy() - x64).max()) / big)
        worst_ref = max(worst_ref, float(np.abs(want - x64).max()) / big)
    print(f"{arch}: gradients' largest distance from f64, as a share of the "
          f"leaf's largest: port f32 {worst_port:.3g}, reference f32 "
          f"{worst_ref:.3g}")
    pnorms, pfinal = port_steps_f32(cfg, params0)
    with f64_casts():
        xnorms = port_steps_f64(cfg, params0)
    print(f"{arch}: 3-step grad norms: reference f32 {jnorms} (in 2 "
          f"microbatches {jnorms2}), port f32 {pnorms}, port f64 {xnorms}")
    pfinal = stacked(pfinal)
    port, split, elem = 0.0, 0.0, 0.0
    for path, want in jax.tree_util.tree_flatten_with_path(jfinal)[0]:
        moved = want - node(params0, path)
        off = node(pfinal, path).detach().numpy() - want
        port = max(port, np.linalg.norm(off) / np.linalg.norm(moved))
        split = max(split, np.linalg.norm(node(jfinal2, path) - want)
                    / np.linalg.norm(moved))
        elem = max(elem, np.abs(off).max() / np.abs(moved).max())
    print(f"{arch}: parameters after 3 steps, per leaf over the reference's "
          f"own movement (2-norms, the largest): port {port:.3g}, the "
          f"reference in 2 microbatches {split:.3g}; the port's largest "
          f"element distance over the leaf's largest movement {elem:.3g}")


class Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.__name__.split(".")[0] not in VIEWS:
            self.n += 1
        return func(*args, **(kwargs or {}))


def ops(fn) -> int:
    with torch.no_grad(), Count() as c:
        fn()
    return c.n


def op_counts():
    ctx = ctx_of(torch.float32)
    for arch, t, block in (("rwkv6-3b", 512, lm._rwkv_block_apply),
                           ("zamba2-7b", 4096, lm._mamba_block_apply),
                           ("zamba2-7b", 4160, lm._mamba_block_apply)):
        cfg = configs.get_smoke(arch)
        p = lm.init(torch.Generator().manual_seed(0), cfg)
        x = torch.randn(1, t, cfg.d_model)
        n = ops(lambda: block(lm.layer(p["blocks"], 0), x, ctx, cfg))
        print(f"{arch}: one layer's forward at t = {t}: {n} ops")
    for arch in ("rwkv6-3b", "zamba2-7b", "h2o-danube-3-4b"):
        base = configs.get_smoke(arch)
        per = []
        for n_layers in ((2, 4) if base.shared_attn_every else (1, 2)):
            cfg = dataclasses.replace(base, n_layers=n_layers)
            p = lm.init(torch.Generator().manual_seed(0), cfg)
            st = lm.init_decode_state(cfg, ctx, 1, 16, device="cpu")
            tok = torch.zeros(1, dtype=torch.long)
            per.append(ops(lambda: lm.decode_step(p, tok, st, ctx, cfg)))
        unit = "group of 2 Mamba layers + the shared block" \
            if base.shared_attn_every else "layer"
        print(f"{arch}: a decode token: {per[1] - per[0]} ops a {unit}, "
              f"{2 * per[0] - per[1]} outside the layers")


def main():
    torch.set_num_threads(2)
    for arch in ("rwkv6-3b", "zamba2-7b"):
        numerics(arch)
    op_counts()


if __name__ == "__main__":
    main()
