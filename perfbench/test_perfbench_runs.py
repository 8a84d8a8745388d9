"""Whole runs of each kind at smoke sizes on the CPU: the port held to the
plain references, the controls read, and the timed path broken on
purpose underneath a run, which must then come out not correct."""
import copy

import pytest
import torch

from perfbench import harness
from perfbench.lib import tiny

SEED = 2 ** 31 + 17


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("bench"))


def run(root, cell, **kw):
    return harness.run_cell(cell, kw.pop("seed", SEED), kw.pop("seconds", 1.0),
                            kw.pop("trace", False), device="cpu", root=root,
                            bench_dir=root / "perfbench", **kw)


@pytest.mark.parametrize("cell", ["tiny.serve", "tiny.moe", "tiny.train",
                                  "tiny.rma"])
def test_port_agrees_with_the_reference(root, cell):
    out = run(root, cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert "setup_s" in out["metrics"]


@pytest.mark.parametrize("cell", ["tiny.serve", "tiny.train", "tiny.rma"])
def test_traced_run_reports_per_layer_metrics(root, cell):
    out = run(root, cell, trace=True, seconds=1.2)
    assert out["correct"]
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["metrics"], "a traced run reports its per-layer metrics"


@pytest.mark.parametrize("cell", ["tiny.serve", "tiny.moe"])
def test_fp8_control_reads_far_above_the_program(root, cell):
    out = run(root, cell, control="fp8")
    assert not out["correct"], out["checks"]
    # the program's own readings are kept beside the control's
    assert any(c["value"] > c["limit"] for c in out["checks"].values())
    for name, c in out["checks"].items():
        assert c["value"] > 10 * max(out["info"][name], 1e-3), name


def test_misdelivery_control_is_not_correct(root):
    out = run(root, "tiny.rma", control="misdeliver")
    assert not out["correct"]
    assert out["checks"]["mismatched_elements"]["value"] > 0


def test_half_batch_control_reads_above_the_program(root):
    out = run(root, "tiny.train", control="half_batch")
    assert not out["correct"], out["checks"]
    prog = out["info"]["program"]
    for name, c in out["checks"].items():
        assert c["value"] > 10 * prog[name], name


def test_a_control_the_kind_lacks_is_refused(root):
    with pytest.raises(ValueError, match="controls"):
        run(root, "tiny.rma", control="fp8")


def _altered_token(eng):
    dec = eng.exec.decode

    def decode(*args):
        toks, pool = dec(*args)
        toks = toks.clone()
        toks[0] = (toks[0] + 1) % eng.cfg.vocab
        return toks, pool
    eng.exec.decode = decode
    return eng


def _unchanged_state(step):
    def broken(state, batch):
        keep = copy.deepcopy({k: v for k, v in state.items()})
        new, m = step(state, batch)
        with torch.no_grad():
            for dst, src in zip(_tensors(new), _tensors(keep)):
                dst.copy_(src)
        new["opt"]["count"] = keep["opt"]["count"]
        return new, m
    return broken


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _tensors(v)]
    return []


def _half_batch(step):
    def broken(state, batch):
        return step(state, {"tokens": batch["tokens"][
            : batch["tokens"].shape[0] // 2]})
    return broken


class _NoExchange:
    """A queue whose puts are dropped: nothing crosses between PEs."""

    def __init__(self, q):
        self.q = q

    def put_nbi(self, *args, **kw):
        return 0

    def __getattr__(self, name):
        return getattr(self.q, name)


class _AlteredAnswer(_NoExchange):
    """A queue that delivers, then changes one element of one block."""

    put_nbi = property(lambda self: self.q.put_nbi)

    def quiet(self):
        state = dict(self.q.quiet())
        name = sorted(state)[0]
        bad = state[name].clone()
        bad.view(-1)[7] += 1
        state[name] = bad
        return state


@pytest.mark.parametrize("cell,fault", [
    ("tiny.serve", _altered_token),
    ("tiny.moe", _altered_token),
    ("tiny.train", _unchanged_state),
    ("tiny.train", _half_batch),
    ("tiny.rma", _NoExchange),
    ("tiny.rma", _AlteredAnswer)])
def test_a_broken_timed_path_is_not_correct(root, cell, fault):
    out = run(root, cell, patch_engine=fault)
    assert not out["correct"], out["checks"]
