"""The yardstick against numbers reckoned by hand."""
import json

import pytest

from perfbench import harness
from perfbench.yardstick import counts, peaks

DENSE, MOE = (json.loads((harness.HERE / "configs" / f"{name}.json")
                         .read_text())
               for name in ("qwen3-8b-bf16", "qwen3-moe-30b-a3b-bf16"))


def test_layer_params():
    # qwen3-8b: q 4096x4096, k and v 4096x1024, o 4096x4096, MLP 3 x
    # 4096 x 12288
    assert counts.layer_params(DENSE) == \
        4096 * 4096 * 2 + 4096 * 1024 * 2 + 3 * 4096 * 12288
    # qwen3-moe: q 2048x4096, k/v 2048x512, o 4096x2048, router 2048x128,
    # 8 experts of 3 x 2048 x 768
    assert counts.layer_params(MOE) == \
        2048 * 4096 * 2 + 2048 * 512 * 2 + 2048 * 128 + 8 * 3 * 2048 * 768


def test_causal_pairs():
    assert counts.causal_pairs(0, 4) == 1 + 2 + 3 + 4
    assert counts.causal_pairs(10, 3) == 11 + 12 + 13


def test_forward_flops_of_one_token():
    per_layer = 2 * counts.layer_params(DENSE) + 4 * 32 * 128 * 5
    assert counts.forward_flops(DENSE, 4, 1) == 36 * per_layer


def test_paged_prefill_bound_is_the_larger_term():
    # one row of 256 queries after 1024 cached tokens, bf16
    pairs = 256 * 1024 + 256 * 257 // 2
    flops = 4 * 32 * 128 * pairs
    nbytes = 2 * 128 * (2 * 256 * 32 + 2 * 1280 * 8)
    want = max(flops / 989e12, nbytes / 3.35e12)
    assert counts.paged_prefill_bound_s(DENSE, [1024], [256], 2,
                                        "bfloat16") == pytest.approx(want)
    assert counts.paged_prefill_bound_s(DENSE, [5], [0], 2, "bfloat16") == 0


def test_flash_bound_f32():
    t, h, d = 4096, 32, 128
    flops = 4 * d * h * t * (t + 1) // 2
    assert counts.flash_bound_s(1, h, 8, t, d, 4, 67e12) == \
        pytest.approx(max(flops / 67e12,
                          (4 * t * d * (2 * h + 16) + 4 * h * t) / 3.35e12))


def test_train_step_flops():
    layers = 8 * counts.layer_params(DENSE) + 151936 * 4096
    attn = 8 * 4 * 32 * 128 * (4096 * 4097 // 2) * 4
    assert counts.train_step_flops(
        dict(DENSE, num_hidden_layers=8), 4, 4096) == \
        pytest.approx(6 * layers * 4 * 4096 + 3 * attn)


def test_rma_bytes_and_peaks():
    assert counts.rma_bytes(8, 4 << 20, 4) == 2 * 8 * 16 * 2 ** 20
    assert peaks.matmul_peak("float32", False) == 67e12
    assert peaks.matmul_peak("float32", True) == 495e12
    assert peaks.matmul_peak("bfloat16", False) == 989e12
