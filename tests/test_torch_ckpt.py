"""repro_torch.ckpt and repro_torch.ft: the nine cases of
``tests/test_ckpt_ft.py`` on the port (round trip, corruption, structure
mismatch, async save and GC, restart on failure, the failure detector,
the elastic plan, stragglers, an unsharded-logical restore), then the
checkpoint across the two packages:

  * the train state in the reference's layout (``state_to_tree``) has
    the JAX train state's leaves, shapes and dtypes, under ZeRO-0 and
    ZeRO-1, and ``state_from_tree`` loads it back bit for bit;
  * a checkpoint the JAX package writes of its smoke gemma-2b train
    state after one step resumes in the port's trainer, and 2 more steps
    give the JAX run's losses and grad norms (rtol 1e-5, the tolerance
    ``test_torch_train.py`` holds the trajectory to);
  * the reference's ``load_checkpoint`` reads the port's checkpoint into
    its tree, leaf for leaf equal;
  * ``launch.train --ckpt-every 1`` then ``--resume`` continues the
    uninterrupted run's loss stream exactly (the same CPU arithmetic on
    a state restored bit for bit);
  * bf16 leaves go through ``ml_dtypes`` as the reference's do.
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import compat
from repro import configs as jconfigs
from repro.ckpt import checkpoint as jckpt
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import registry as jregistry
from repro.parallel.ctx import ParallelCtx as JCtx
from repro.parallel.ctx import smap
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.optimizer import adamw_init as jadamw_init
from repro.train.step import make_train_step as jmake_train_step
from repro.train.step import train_state_specs
from repro_torch import configs
from repro_torch.ckpt import Checkpointer, load_checkpoint, save_checkpoint
from repro_torch.data import SyntheticLM
from repro_torch.ft import (FailureDetector, StragglerPolicy,
                            plan_elastic_remesh, run_with_restarts)
from repro_torch.launch import train as launch
from repro_torch.models import lm, registry
from repro_torch.parallel import ParallelCtx
from repro_torch.train import (AdamWConfig, make_train_step, state_from_tree,
                               state_to_tree, tree)
from repro_torch.train.step import train_state_from
from repro_torch.weights import from_jax

torch.set_num_threads(2)

LR = 5e-3
JCTX = JCtx(dp_size=1, tp_size=1, sp=False, remat=True,
            param_dtype=jnp.float32, compute_dtype=jnp.float32)
CTX = ParallelCtx(remat=True, param_dtype=torch.float32,
                  compute_dtype=torch.float32)


def _tree():
    count = torch.zeros((), dtype=torch.int32)
    return {"w": torch.arange(12.0).reshape(3, 4),
            "opt": {"m": torch.ones(5), "count": count}}


def _same(a, b):
    for x, y in zip(tree.leaves(a), tree.leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y), (x, y)


# ======================================================================
# the reference's nine cases
# ======================================================================
def test_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 7, t)
    loaded, step = load_checkpoint(str(tmp_path), t)
    assert step == 7
    _same(t, loaded)
    manifest = json.load(open(tmp_path / "step_7" / "manifest.json"))
    assert manifest["n_leaves"] == 3 and manifest["step"] == 7
    assert manifest["treedef"] == "{'opt': {'count': *, 'm': *}, 'w': *}"
    assert [m["dtype"] for m in manifest["leaves"]] == ["int32", "float32",
                                                        "float32"]
    assert sorted(os.listdir(tmp_path)) == ["step_7"]        # no .tmp left


def test_corruption_detected(tmp_path):
    t = _tree()
    path = save_checkpoint(str(tmp_path), 1, t)
    victim = os.path.join(path, "leaf_0.npy")
    raw = bytearray(open(victim, "rb").read())
    raw[-1] ^= 0xFF
    open(victim, "wb").write(bytes(raw))
    with pytest.raises(IOError):
        load_checkpoint(str(tmp_path), t)


def test_structure_mismatch(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    with pytest.raises(ValueError):
        load_checkpoint(str(tmp_path), {"only": torch.zeros(())})
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "empty"), _tree())


def test_async_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    t = _tree()
    for s in (1, 2, 3, 4):
        ck.save_async(s, tree.tree_map(lambda x: x + s, t))
    ck.wait()
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_3", "step_4"]
    loaded, step = ck.restore(t)
    assert step == 4
    np.testing.assert_allclose(loaded["w"].numpy(), t["w"].numpy() + 4)


def test_async_save_snapshots_at_the_call(tmp_path):
    """The port's trainer updates its state in place, so ``save_async``
    copies the tree before it returns: a later write does not reach
    the checkpoint."""
    ck = Checkpointer(str(tmp_path))
    t = _tree()
    ck.save_async(1, t)
    t["w"].add_(100.0)
    loaded, _ = ck.restore(_tree())
    _same(_tree(), loaded)


def test_a_failed_background_save_raises_at_wait(tmp_path, monkeypatch):
    """A save that fails on the worker thread is not lost: the next
    ``wait`` raises it (once), and the checkpointer goes on."""
    from repro_torch.ckpt import checkpoint as ckmod

    def broken(*a, **k):
        raise OSError("disk full")

    ck = Checkpointer(str(tmp_path))
    monkeypatch.setattr(ckmod, "save_checkpoint", broken)
    ck.save_async(1, _tree())
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    ck.wait()
    monkeypatch.undo()
    ck.save_async(2, _tree())
    assert ck.restore(_tree())[1] == 2


def test_run_with_restarts(tmp_path):
    """Injected failures at steps 7 and 13: the restart loop restores and
    finishes all 20 steps; the loss stream is a function of the step
    id (no lost or repeated data)."""
    ck = Checkpointer(str(tmp_path), keep=3)

    def init_state(attempt):
        return {"x": torch.zeros(())}

    def make_step(attempt):
        def step(state, step_id):
            return {"x": state["x"] + 1}, {"loss": 100.0 - step_id}
        return step

    ck.save_async(0, init_state(0))
    ck.wait()
    state, info = run_with_restarts(
        make_step, init_state, ck, n_steps=20,
        failure_schedule={7: RuntimeError("node died"),
                          13: IOError("link flap")},
        ckpt_every=5)
    assert info["restarts"] == 2
    assert info["final_step"] == 20
    assert info["losses"][-1] == 100.0 - 19
    assert float(state["x"]) == 20.0        # restored, then stepped on


def test_failure_detector():
    fd = FailureDetector(n_nodes=4, timeout_s=10.0)
    for n in range(4):
        fd.heartbeat(n, t=0.0)
    assert fd.check(now=5.0) == []
    fd.heartbeat(0, t=11.0)
    fd.heartbeat(1, t=11.0)
    assert fd.check(now=12.0) == [2, 3]
    fd.inject_failure(1)
    assert fd.alive(now=12.0) == [0]


def test_elastic_plan():
    p = plan_elastic_remesh(alive_pods=1, pods=2, data=16, model=16)
    assert p.mesh_shape == (1, 16, 16)
    assert p.dp_size == 16 and p.tp_size == 16
    assert p.dropped_replicas == 16
    q = plan_elastic_remesh(alive_pods=1, pods=2, data=4, model=2,
                            multi_pod=False)
    assert q.mesh_shape == (4, 2) and q.dropped_replicas == 0
    with pytest.raises(RuntimeError):
        plan_elastic_remesh(alive_pods=0, pods=2, data=16, model=16)


def test_straggler_policy():
    sp = StragglerPolicy(deadline_s=10.0, demote_after=2)
    assert sp.record(3, 5.0) == "ok"
    assert sp.record(3, 50.0) == "skip"
    assert sp.record(3, 50.0) == "demote"
    assert sp.record(3, 5.0) == "ok"       # reset after success
    assert sp.grad_weight(["ok", "skip", "ok", "ok"]) == pytest.approx(4 / 3)
    assert sp.grad_weight(["skip", "skip"]) == 0.0


def test_elastic_restore_across_mesh(tmp_path):
    """A checkpoint saved under one layout loads under another: arrays
    are stored unsharded-logical, so 8 row shards of the loaded leaf (8
    PEs' pieces) reassemble it, and a meta template loads on the CPU."""
    t = {"w": torch.arange(64.0).reshape(8, 8)}
    save_checkpoint(str(tmp_path), 3, t)
    loaded, _ = load_checkpoint(str(tmp_path),
                                {"w": torch.empty(8, 8, device="meta")})
    assert loaded["w"].device.type == "cpu"
    shards = torch.chunk(loaded["w"], 8, dim=0)
    assert torch.equal(torch.cat(shards), t["w"])


# ======================================================================
# across the packages
# ======================================================================
def _jax_state(arch, zero=0, steps=0):
    """The reference's train state (``init`` from PRNGKey(0), as
    ``launch/train.py`` builds it) after ``steps`` steps, and the
    metrics of each step."""
    cfg = jconfigs.get_smoke(arch)
    api = jregistry.build(cfg)
    opt = JAdamWConfig(lr=LR, zero=zero)
    mesh = compat.make_mesh((1, 1), ("data", "model"))
    sspecs = train_state_specs(cfg, JCTX, api, opt)
    params = api.init(jax.random.PRNGKey(0), cfg, JCTX)
    state = {"params": params,
             "opt": smap(lambda p: jadamw_init(p, JCTX, opt), mesh,
                         (api.specs(cfg, JCTX),), sspecs["opt"])(params),
             "step": jnp.zeros((), jnp.int32)}
    fn = jax.jit(smap(jmake_train_step(cfg, JCTX, api, opt), mesh,
                      (sspecs, {"tokens": P("data")}),
                      (sspecs, {"loss": P(), "grad_norm": P(),
                                "step": P()})))
    data = JSyntheticLM(vocab=cfg.vocab, seq_len=cfg.max_seq, global_batch=8)
    metrics = []
    for s in range(steps):
        state, m = fn(state, data.batch(s))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return state, metrics, fn, data


def _port_state(arch, params=None, zero=0):
    cfg = configs.get_smoke(arch)
    if params is None:
        params = lm.init(torch.Generator().manual_seed(0), cfg)
    opt = AdamWConfig(lr=LR, zero=zero)
    state = train_state_from(params, CTX, opt)
    step = make_train_step(cfg, CTX, registry.build(cfg), opt)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=cfg.max_seq, global_batch=8)
    return state, step, data


@pytest.mark.parametrize("zero", [0, 1])
def test_state_tree_is_the_references_train_state(zero):
    """``state_to_tree``: the JAX train state's leaves, in its order,
    with its shapes and dtypes; ``state_from_tree`` of it into a fresh
    state gives the original state back bit for bit."""
    jstate = _jax_state("gemma-2b", zero)[0]
    state, step, data = _port_state("gemma-2b", zero=zero)
    state, _ = step(state, data.batch(0, device="cpu"))
    t = state_to_tree(state)
    jflat = jax.tree_util.tree_flatten_with_path(jstate)[0]
    flat = tree.leaves(t)
    assert len(flat) == len(jflat)
    for (path, want), got in zip(jflat, flat):
        assert tuple(got.shape) == want.shape, path
        assert str(got.dtype).split(".")[1] == str(want.dtype), path
    assert int(t["opt"]["count"]) == 1 and int(t["step"]) == 1
    fresh, _, _ = _port_state("gemma-2b", zero=zero)
    out = state_from_tree(fresh, t)
    assert out is fresh and fresh["step"] == 1
    assert fresh["opt"]["count"] == 1
    _same(state_to_tree(fresh), t)
    _same(state["params"], fresh["params"])
    with pytest.raises(ValueError):
        state_from_tree(fresh, {**t, "params": {
            **t["params"], "embed": {"table": t["params"]["embed"]["table"]
                                     .double()}}})


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX package checkpoints its gemma-2b smoke train state after
    one step; the port's trainer restores it and takes steps 1 and 2:
    the losses and grad norms of the JAX run's own steps 1 and 2."""
    jstate, jmetrics, fn, jdata = _jax_state("gemma-2b", steps=1)
    jckpt.save_checkpoint(str(tmp_path), 1, jstate)
    want = []
    for s in (1, 2):
        jstate, m = fn(jstate, jdata.batch(s))
        want.append((float(m["loss"]), float(m["grad_norm"])))
    tr = launch.build_trainer("gemma-2b", smoke=True, device="cpu", lr=LR,
                              seed=5)
    assert tr.restore(Checkpointer(str(tmp_path))) == 1
    assert tr.state["step"] == 1 and tr.state["opt"]["count"] == 1
    got = []
    for s in (1, 2):
        m = tr.step(s)
        got.append((m["loss"], m["grad_norm"]))
        assert m["step"] == s + 1
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-5)


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    """The reverse: the port's checkpoint of its train state (after one
    step, from the JAX init) loads through the reference's
    ``load_checkpoint`` into the JAX state's tree, leaf for leaf equal
    to the port's state."""
    jstate = _jax_state("gemma-2b")[0]
    state, step, data = _port_state(
        "gemma-2b", params=from_jax(jax.tree.map(np.asarray,
                                                 jstate["params"])))
    state, _ = step(state, data.batch(0, device="cpu"))
    tr = launch.Trainer(configs.get_smoke("gemma-2b"), CTX, state, step,
                        data, torch.device("cpu"))
    ck = Checkpointer(str(tmp_path))
    tr.save(ck, 1)
    ck.wait()
    loaded, s = jckpt.load_checkpoint(str(tmp_path), jstate)
    assert s == 1
    want = state_to_tree(state)
    jflat = jax.tree_util.tree_flatten_with_path(loaded)[0]
    assert len(jflat) == len(tree.leaves(want))
    for (path, got), w in zip(jflat, tree.leaves(want)):
        assert got.dtype == w.numpy().dtype, path
        np.testing.assert_array_equal(got, w.numpy(), err_msg=str(path))


def test_train_cli_resume_continues_the_loss_stream(tmp_path, capsys):
    """``--ckpt-every 1`` for 2 steps, then ``--resume`` to 4: steps 2
    and 3 give the uninterrupted 4-step run's losses exactly."""
    base = ["--arch", "gemma-2b", "--smoke", "--device", "cpu",
            "--microbatches", "2"]
    whole = launch.main(base + ["--steps", "4", "--ckpt-every", "100",
                                "--ckpt-dir", str(tmp_path / "a")])
    first = launch.main(base + ["--steps", "2", "--ckpt-every", "1",
                                "--ckpt-dir", str(tmp_path / "b")])
    assert sorted(os.listdir(tmp_path / "b")) == ["step_1", "step_2"]
    rest = launch.main(base + ["--steps", "4", "--ckpt-every", "1",
                               "--ckpt-dir", str(tmp_path / "b"),
                               "--resume"])
    out = capsys.readouterr().out
    assert "resumed at step 2" in out and "training complete" in out
    assert [m["step"] for m in rest] == [3, 4]
    assert [m["loss"] for m in first + rest] == [m["loss"] for m in whole]
    assert sorted(os.listdir(tmp_path / "b")) == ["step_2", "step_3",
                                                  "step_4"]     # keep=3
    assert os.listdir(tmp_path / "a") == []


def test_bf16_leaves_go_through_ml_dtypes(tmp_path, monkeypatch):
    """A bf16 leaf is saved as ``ml_dtypes.bfloat16`` (the reference's
    dtype string and bytes), loads back as the same bits in the port and
    as the same 16-bit words in the reference; without ``ml_dtypes``
    saving one raises a clear error."""
    t = {"w": (torch.randn(4, 6, generator=torch.Generator().manual_seed(1))
               * 10).to(torch.bfloat16)}
    save_checkpoint(str(tmp_path), 1, t)
    manifest = json.load(open(tmp_path / "step_1" / "manifest.json"))
    assert manifest["leaves"][0]["dtype"] == "bfloat16"
    loaded, _ = load_checkpoint(str(tmp_path), t)
    _same(t, loaded)
    jl, _ = jckpt.load_checkpoint(str(tmp_path),
                                  {"w": jnp.zeros((4, 6), jnp.bfloat16)})
    np.testing.assert_array_equal(np.asarray(jl["w"]).view(np.int16),
                                  t["w"].view(torch.int16).numpy())
    jckpt.save_checkpoint(str(tmp_path / "j"), 2,
                          {"w": jnp.asarray(np.asarray(
                              t["w"].float().numpy()), jnp.bfloat16)})
    back, _ = load_checkpoint(str(tmp_path / "j"), t)
    _same(t, back)
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    with pytest.raises(RuntimeError, match="ml_dtypes"):
        save_checkpoint(str(tmp_path), 2, t)
