"""posh-micro — the paper's own configuration — in the port, and its
experiment, ``examples/torch/shmem_pingpong.py``:

* the config equals the reference's field by field (full and smoke);
  ``configs.get`` returns it, and the model entry points refuse it by
  family with a plain message, as the reference has no model for it;
* the smoke sweep of ``tests/multipe/run_ordering.py``'s
  ``check_posh_micro_sweep`` (ring-neighbour ``put_nbi``, one fence a
  size), in process with no mesh: the port's queue over its stacked
  ``PermuteTransport`` and the reference's over its numpy
  ``LocalTransport`` give ``np.roll(x, 1, axis=0)`` exactly;
* the pingpong example's sweep (every op, both stagers, the pipeline)
  holds every output to its rolled input bit for bit, and the script
  runs with ``--device cpu --smoke``; the other four examples each run
  one smoke step on the CPU.
"""
import dataclasses
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import core as jcore
from repro_torch import configs
from repro_torch.core import CommQueue, SymmetricHeap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples", "torch")
N = 8


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"ex_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_config_equals_the_reference():
    for get in ("get", "get_smoke"):
        port = getattr(configs, get)("posh-micro")
        ref = getattr(jconfigs, get)("posh-micro")
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    full = configs.get("posh-micro")
    assert full.buffer_sizes == tuple(4 ** i for i in range(2, 12))
    assert (full.warmup, full.repeats) == (3, 20)
    assert full.dtypes == ("float32", "bfloat16", "int32")
    assert configs.get("posh_micro") == full


def test_model_entry_points_refuse_it_by_family():
    from repro_torch.launch.serve import build_engine
    from repro_torch.launch.train import build_trainer
    from repro_torch.models import registry
    from repro_torch.weights import shard_for_tp
    cfg = configs.get("posh-micro")
    for call in (lambda: registry.build(cfg),
                 lambda: registry.tp_specs(cfg, 2),
                 lambda: shard_for_tp({}, cfg, 1),
                 lambda: build_trainer("posh-micro", device="cpu"),
                 lambda: build_engine("posh-micro", device="cpu")):
        with pytest.raises(ValueError, match="not a model") as e:
            call()
        assert "A1" not in str(e.value)


def test_smoke_sweep_equals_the_reference_result():
    micro = configs.get_smoke("posh-micro")
    pairs = [(i, (i + 1) % N) for i in range(N)]
    heap = SymmetricHeap(("pe",))
    jheap = jcore.SymmetricHeap(("pe",))
    for elems in micro.buffer_sizes:
        h = heap.alloc(f"sweep{elems}", (elems,), torch.float32)
        jh = jheap.alloc(f"sweep{elems}", (elems,), np.float32)
        x = np.arange(N * elems, dtype=np.float32).reshape(N, elems)
        q = CommQueue("pe", heap.zeros_state(N, device="cpu"))
        q.put_nbi(h, torch.from_numpy(x), pairs)
        q.fence()                          # the ordering point delivers
        got = q.state[h.name].numpy()
        jq = jcore.CommQueue("pe", {jh.name: np.zeros((N, elems),
                                                      np.float32)},
                             transport=jcore.LocalTransport(N))
        jq.put_nbi(jh, x, pairs)
        jq.fence()
        want = np.roll(x, 1, axis=0)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(np.asarray(jq.state[jh.name]), want)


def test_pingpong_sweep_rolls_every_input_bit_for_bit():
    pp = _example("shmem_pingpong")
    rows = pp.sweep(configs.get_smoke("posh-micro"), torch.device("cpu"))
    cfg = configs.get_smoke("posh-micro")
    assert len(rows) == len(cfg.dtypes) * (
        len(cfg.buffer_sizes) * len(pp.SWEEP_OPS) + 2) * len(pp.STAGERS)
    assert pp.failures(rows) == []
    assert all(r["ok"] for r in rows)
    assert all(r["same_as_default"] for r in rows if r["stager"] == "copy")
    # the launch model: one staged round a put / get / coalesced nbi, K
    # a blocking pipeline, none a local copy ("stock" below one tile)
    assert pp.staged_rounds("nbi", 4096, torch.float32) == [16384]
    assert pp.staged_rounds("blocking", 4096, torch.float32) == [2048] * 8
    assert pp.staged_rounds("copy", 4096, torch.float32) == []
    assert pp.expected_launches("put", 16, torch.float32) == 0
    assert pp.expected_launches("put", 1 << 20, torch.bfloat16) == 1


def test_pingpong_script_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, os.path.join(EXAMPLES,
                                                     "shmem_pingpong.py"),
                        "--device", "cpu", "--smoke"], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "stager default:" in r.stdout and "stager copy:" in r.stdout
    assert "8 x 256 puts via nbi" in r.stdout


def test_other_examples_run_a_smoke_step_on_the_cpu(tmp_path):
    losses = _example("quickstart").main(["--device", "cpu", "--steps", "1"])
    assert len(losses) == 1 and np.isfinite(losses[0])
    out = _example("train_lm").main(
        ["--device", "cpu", "--steps", "1", "--ckpt-every", "1",
         "--ckpt-dir", str(tmp_path)])
    assert len(out) == 1 and np.isfinite(out[0]["loss"])
    streams = _example("serve_quickstart").main(["--device", "cpu"])
    assert sorted(streams) == [0, 1, 2]
    assert [len(streams[i]) for i in range(3)] == [5, 7, 3]
    seqs = _example("serve_decode").main(["--device", "cpu",
                                          "--new-tokens", "2"])
    assert len(seqs) == 4 and all(len(s) == 3 for s in seqs)
