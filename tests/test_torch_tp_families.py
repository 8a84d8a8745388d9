"""Tensor-parallel training and decode of the rwkv6, zamba2, whisper and
vlm families, the MoE decode and the gathered cross-entropy, against
the JAX reference's mesh and the port at tp = 1, on the CPU.

As ``test_torch_tp_ctx.py`` (whose worker helpers this file drives),
the reference runs in a subprocess with 8 fake CPU devices, its
programs compiled on a thread pool, the run cached in a module fixture
and its CPU seconds bounded.  The port runs the same weights and
batches with the kernels' plain versions.

Held to the reference and to the port at tp = 1:

  (1) ``tests/multipe/run_tp_equiv``'s remaining cases at DP 2 x TP 4
      with ``sp`` and remat: rwkv6-3b under posh (4 padded heads, one a
      PE), zamba2-7b under xla (the SSD heads split, the gated norm's
      psum, the shared block in the head layout), whisper-base under xla
      (head layout; the encoder with ``sp`` off); and the vlm
      (llama-3.2-vision-90b, its 2 KV heads replicated at tp 4) with
      both gates non-zero, and qwen3-8b with ``ce_mode="gathered"``:
      the loss within rtol 2e-5, every leaf's global gradient within
      5e-4 of its largest, that suite's tolerances;
  (2) the contiguous-cache decode at TP 4 on a (1, 4) mesh for rwkv6-3b
      (``S`` and ``x_prev`` per PE), zamba2-7b (the SSD state, the bf16
      conv buffers and the one shared cache, a ring of 16 that wraps),
      whisper-base, the vlm (``img_kv`` with each PE's KV head) and
      qwen3-moe-30b-a3b: greedy streams token for token and the final
      state per PE (``test_torch_decode``'s rules); each stream equals
      the port's tp = 1 stream too, but zamba2's, whose one shared cache
      (ROADMAP §C) is held to the reference only.
"""
import sys

import numpy as np
import pytest
import torch

from test_torch_tp_ctx import (DEC_STEPS, ctx_of, hold_equiv, hold_state,
                               port_decode, port_loss_grads, ref_decode,
                               ref_equiv, run_worker, spawn_worker)
from test_torch_tp_train import _key

torch.set_num_threads(2)

# (arch, backend, dp, tp, ce_mode) of the equivalence runs
EQUIV = (("rwkv6-3b", "posh", 2, 4, "vocab_parallel"),
         ("zamba2-7b", "xla", 2, 4, "vocab_parallel"),
         ("whisper-base", "xla", 2, 4, "vocab_parallel"),
         ("llama-3.2-vision-90b", "xla", 2, 4, "vocab_parallel"),
         ("qwen3-8b", "xla", 2, 4, "gathered"))
DECODE = ("rwkv6-3b", "zamba2-7b", "whisper-base", "llama-3.2-vision-90b",
          "qwen3-moe-30b-a3b")
# held to the reference only: one cache for every shared-block
# application (ROADMAP §C), so its decode is not tp = 1's forward
REF_ONLY = ("zamba2-7b",)
ARCHS = tuple(sorted({c[0] for c in EQUIV} | set(DECODE)))


def _jax_worker(out_path: str) -> None:
    jobs = [lambda m, c=c: ref_equiv(m, *c) for c in EQUIV]
    jobs += [lambda m, a=a: ref_decode(m, a, 4, DEC_STEPS) for a in DECODE]
    run_worker(out_path, ARCHS, jobs)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    # LLVM at -O0: a third fewer CPU seconds of compile for these small
    # programs (IEEE arithmetic at every level: no fast-math); the
    # trajectory, whose Adam steps amplify the last bits, runs at the
    # default in test_torch_tp_ctx.py
    return spawn_worker(__file__, tmp_path_factory, "jax_tp_families",
                        "--xla_backend_optimization_level=0")


@pytest.mark.parametrize("case", EQUIV, ids=lambda c: f"{c[0]}-{c[1]}-"
                         f"{c[4]}")
def test_dp2_tp4_matches_tp1_and_the_reference(ref, case):
    """(1): loss rtol 2e-5, gradients 5e-4 of each leaf's largest."""
    arch, ce = case[0], case[4]
    if arch == "llama-3.2-vision-90b":
        cross = ref[f"params0:{arch}:cross/xgate"]
        assert np.all(cross != 0)
    hold_equiv(ref, port_loss_grads(ref, arch, ctx_of(ce=ce)), case)


@pytest.mark.parametrize("arch", DECODE)
def test_tp4_decode_matches_the_reference_and_tp1(ref, arch):
    """(2): the streams token for token, the state per PE."""
    stream, states = port_decode(ref, arch, 4)
    np.testing.assert_array_equal(stream,
                                  ref[_key("decode", arch, 4, "stream")])
    hold_state(ref, arch, 4, DEC_STEPS, states)
    if arch not in REF_ONLY:
        np.testing.assert_array_equal(stream, port_decode(ref, arch, 1)[0])


def test_reference_worker_within_budget(ref):
    """The JAX worker's CPU seconds (compiles included: 5 DP2 x TP4
    loss-and-grad programs, 5 decode programs) stay inside the tier-1
    budget; its wall seconds are reported."""
    print(f"JAX worker: {float(ref['cpu_seconds']):.1f} CPU s, "
          f"{float(ref['seconds']):.1f} s of wall")
    assert float(ref["cpu_seconds"]) < 120


if __name__ == "__main__" and "--jax-worker" in sys.argv:
    _jax_worker(sys.argv[sys.argv.index("--jax-worker") + 1])
