"""repro_torch on the GPU: the CUDA paged-attention kernels against
their plain PyTorch versions over the reference's parity corpus
(mid-page starts, full final pages, padded and inactive rows, the verify
shape, GQA/MQA, f32/bf16, length 0), the edges of the bf16 prefill
kernel's tiles and verify windows at qwen3-8b's width, and the engine's
kernel path, speculative decoding included; the copy and combine
kernels and the pallas backend; the flash-attention kernel against its
plain version (its tile edges, the models' layouts, the 16-byte row
check), the autograd path through it, and smoke-config training with
it.

Every test here needs a CUDA GPU and skips without one (the kernels are
CUDA C++ with no CPU mode); on the H100 host:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

This file imports no JAX, so it runs where JAX is not installed; the
cases are shared with ``test_torch_kernels.py``, which holds the
plain versions against the JAX oracles on the CPU.

Tolerances: f32 1e-5 (the same masked softmax in f32, summed in another
order); bf16 3e-2 (the reference's own bf16 window tolerance: both
sides read the same bf16 inputs, accumulate in f32 and round the output
to bf16 once; the tensor-core kernels also round the probabilities to
bf16 for P V, which stays inside it, ``PERF.md``).  bf16 decode is also
held to 2e-2 of max |plain|: at 4096 tokens the outputs are smaller than
3e-2, and a merge that lost a partition would pass the absolute bound.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import paged_attention as pa

torch.set_num_threads(2)

TOL = {"f32": 1e-5, "bf16": 3e-2}
SCALE_TOL = 2e-2
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
PROMPTS = [list(range(3, 9)), list(range(4, 10)), [7, 3, 99, 12]]


def _to_torch(a, dt="f32"):
    return torch.from_numpy(np.array(a, np.float32)).to(TDT[dt])


def _i32(a):
    return torch.from_numpy(np.array(a, np.int32))


def _close(got, want, dt, msg=""):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dt], rtol=TOL[dt], err_msg=msg)


def _tensors(case, dt, device):
    """numpy case -> torch tensors on ``device`` (floats in ``dt``)."""
    return [(_to_torch(a, dt) if a.dtype == np.float32 else _i32(a))
            .to(device) for a in case]


# ======================================================================
# decode
# ======================================================================
def _paged_case(seed=0, B=3, H=4, Hkv=2, D=16, P=4, n_pages=10, slots=3,
                lens=None):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, D).astype(np.float32)
    kp = rng.randn(n_pages, P, Hkv, D).astype(np.float32)
    vp = rng.randn(n_pages, P, Hkv, D).astype(np.float32)
    bt = rng.permutation(np.arange(1, n_pages))[:B * slots] \
        .reshape(B, slots).astype(np.int32)
    lens = np.array([P * slots, 5, 0] if lens is None else lens, np.int32)
    return q, kp, vp, bt, lens


def _full_final_page_case():
    rng = np.random.RandomState(3)
    B, H, Hkv, D, P, n_pages, slots = 3, 4, 2, 16, 4, 12, 6
    q = rng.randn(B, H, D).astype(np.float32)
    kp = rng.randn(n_pages, P, Hkv, D).astype(np.float32)
    vp = rng.randn(n_pages, P, Hkv, D).astype(np.float32)
    bt = np.zeros((B, slots), np.int32)
    bt[0, :2] = [1, 2]
    bt[1, :3] = [3, 4, 5]
    bt[2, :6] = [6, 7, 8, 9, 10, 11]
    return q, kp, vp, bt, np.array([2 * P, 3 * P, 6 * P], np.int32)


def _midpage_decode_case(L):
    rng = np.random.RandomState(4)
    q = rng.randn(1, 4, 16).astype(np.float32)
    kp = rng.randn(8, 4, 2, 16).astype(np.float32)
    vp = rng.randn(8, 4, 2, 16).astype(np.float32)
    return q, kp, vp, np.array([[1, 2, 0, 0]], np.int32), \
        np.array([L + 1], np.int32)


DECODE_CASES = {
    "mixed_lengths": lambda: _paged_case(),
    "full_final_page": _full_final_page_case,
    "first_decode_after_midpage_prefill_5": lambda: _midpage_decode_case(5),
    "first_decode_after_midpage_prefill_6": lambda: _midpage_decode_case(6),
    "first_decode_after_midpage_prefill_7": lambda: _midpage_decode_case(7),
    "gqa_4_1": lambda: _paged_case(seed=41, H=4, Hkv=1),
    "gqa_6_2": lambda: _paged_case(seed=62, H=6, Hkv=2),
    "mha_4_4": lambda: _paged_case(seed=44, H=4, Hkv=4),
}


# the edges of the decode kernels' partitions (pa.DECODE_TOKENS tokens in
# bf16, pa.DECODE_TOKENS_F32 in f32), at full head width (H=32, H_kv=8,
# D=128 unless named): sequences over several partitions with a ragged
# last one; lengths that are exact multiples of the partition beside 0
# and 1; a page size (12) that does not divide it; a 4096-token context;
# lengths past the table's reach (clamped); GQA groups 8 and 1 at head
# dims 256 and 64 (f32 partitions there too)
def _decode_pool(seed, lens, P=16, slots=64, H=32, Hkv=8, D=128, layers=1):
    """q, a (n_pages, 2, layers, P, H_kv, D) page pool as the engine keeps
    it, block tables and lengths."""
    rng = np.random.RandomState(seed)
    B = len(lens)
    n_pages = B * slots + 1
    q = rng.randn(B, H, D).astype(np.float32)
    pool = rng.randn(n_pages, 2, layers, P, Hkv, D).astype(np.float32)
    bt = rng.permutation(np.arange(1, n_pages)).reshape(B, slots) \
        .astype(np.int32)
    return q, pool, bt, np.array(lens, np.int32)


def _decode_full(seed, lens, **kw):
    q, pool, bt, lens = _decode_pool(seed, lens, **kw)
    return q, pool[:, 0, 0], pool[:, 1, 0], bt, lens


_T = pa.DECODE_TOKENS
_T32, _T32_256 = pa.DECODE_TOKENS_F32[128], pa.DECODE_TOKENS_F32[256]
DECODE_EDGE_CASES = {
    "several_partitions_ragged_last": lambda: _decode_full(
        80, [3 * _T + 5, 2 * _T + 2, _T + 1, 200]),
    "exact_partition_multiples_0_1": lambda: _decode_full(
        81, [_T, 2 * _T, 0, 1, 4 * _T]),
    "page_12_not_dividing_the_partition": lambda: _decode_full(
        82, [100, 37, 250, 12], P=12, slots=24),
    "long_context_4096": lambda: _decode_full(
        83, [4096, 4095], slots=256),
    "lengths_past_the_tables_reach": lambda: _decode_full(
        84, [2000, 5, 1024, 1025], slots=64),
    "group_8_d256": lambda: _decode_full(
        85, [300, 64, 1], H=8, Hkv=1, D=256, slots=24),
    "group_1_d64": lambda: _decode_full(
        86, [129, 7], H=4, Hkv=4, D=64, slots=12),
    "f32_partition_multiples_0_1": lambda: _decode_full(
        90, [_T32, 2 * _T32, 0, 1, 5 * _T32, 3 * _T32]),
    "f32_partition_ragged_last": lambda: _decode_full(
        91, [3 * _T32 + 5, _T32 + 1, 2 * _T32 - 1, 7 * _T32 + 33]),
    "f32_partition_page_12": lambda: _decode_full(
        92, [_T32, 100, 37, 3 * _T32 + 12, 250], P=12, slots=24),
    "f32_partition_group_8_d256": lambda: _decode_full(
        93, [4 * _T32_256 + 1, 2 * _T32_256, _T32_256 - 1, 0], H=8, Hkv=1,
        D=256, slots=24),
    # the MoE archs' layouts at full width: qwen3-moe-30b-a3b (H 32,
    # H_kv 4: group 8) and qwen2-moe-a2.7b (H 16, H_kv 16: group 1), D 128
    "moe_qwen3_group_8_d128": lambda: _decode_full(
        94, [0, 1, 9, 16, 100, 256, 512, 777], H=32, Hkv=4, D=128),
    "moe_qwen2_group_1_d128": lambda: _decode_full(
        95, [0, 1, 9, 16, 100, 256, 512, 777], H=16, Hkv=16, D=128),
}
DECODE_GPU_CASES = {**DECODE_CASES, **DECODE_EDGE_CASES}


# ======================================================================
# prefill window
# ======================================================================
def _window_case(seed, B, C, H, Hkv, D, P, slots, start=None, n_tok=None):
    rng = np.random.RandomState(seed)
    n_pages = B * slots + 1
    q = rng.randn(B, C, H, D).astype(np.float32)
    kp = rng.randn(n_pages, P, Hkv, D).astype(np.float32)
    vp = rng.randn(n_pages, P, Hkv, D).astype(np.float32)
    bt = rng.permutation(np.arange(1, n_pages)).reshape(B, slots) \
        .astype(np.int32)
    if start is None:
        start = rng.randint(0, max(P * slots - C, 0) + 1, B)
    if n_tok is None:
        n_tok = rng.randint(0, C + 1, B)
    return (q, kp, vp, bt, np.asarray(start, np.int32),
            np.asarray(n_tok, np.int32))


WINDOW_CASES = {
    "midpage_starts_a": lambda: _window_case(
        10, 3, 8, 4, 2, 16, 8, 3, start=[1, 5, 3], n_tok=[8, 8, 5]),
    "midpage_starts_b": lambda: _window_case(
        11, 3, 8, 4, 2, 16, 8, 3, start=[7, 2, 6], n_tok=[8, 8, 5]),
    "full_final_page": lambda: _window_case(
        20, 2, 8, 4, 2, 16, 4, 4, start=[0, 8], n_tok=[8, 8]),
    "padded_and_inactive_rows": lambda: _window_case(
        30, 4, 8, 4, 2, 16, 8, 2, start=[0, 3, 5, 0], n_tok=[8, 4, 1, 0]),
    "verify_shape_k1": lambda: _window_case(
        41, 3, 2, 4, 1, 16, 8, 4, start=[13, 26, 7], n_tok=[2, 2, 2]),
    "verify_shape_k3": lambda: _window_case(
        43, 3, 4, 4, 1, 16, 8, 4, start=[13, 26, 7], n_tok=[4, 4, 4]),
    "wide_window": lambda: _window_case(50, 2, 16, 8, 2, 16, 4, 8),
    "ragged_window_7": lambda: _window_case(67, 2, 7, 4, 2, 16, 8, 4),
    "ragged_window_13": lambda: _window_case(73, 2, 13, 4, 2, 16, 8, 4),
    "gqa_4_1": lambda: _window_case(111, 2, 8, 4, 1, 16, 8, 3),
    "gqa_6_2": lambda: _window_case(132, 2, 8, 6, 2, 16, 8, 3),
    "mha_4_4": lambda: _window_case(114, 2, 8, 4, 4, 16, 8, 3),
}


# the edges of the bf16 prefill kernel's tiles (64 score rows x 64
# tokens), at full head width: starts mid-page, n_tok partial and 0, C
# below one slab, groups 1 / 4 / 8, contexts past one tile up to the
# table's 1024 tokens, a page size (12) that does not divide the tile,
# and rows whose positions run past the table (they see all of it)
PREFILL_EDGE_CASES = {
    "qwen_width_midpage_partial_idle": lambda: _window_case(
        60, 4, 64, 32, 8, 128, 16, 64, start=[5, 100, 0, 937],
        n_tok=[64, 30, 0, 23]),
    "context_to_1024": lambda: _window_case(
        61, 2, 16, 8, 2, 128, 16, 64, start=[1008, 999], n_tok=[16, 16]),
    "c_below_one_slab_g8": lambda: _window_case(
        62, 3, 3, 8, 1, 64, 16, 8, start=[70, 3, 0], n_tok=[3, 2, 1]),
    "group_1_past_one_tile": lambda: _window_case(
        63, 2, 32, 4, 4, 128, 16, 16, start=[200, 17], n_tok=[32, 5]),
    "group_8_d256": lambda: _window_case(
        64, 2, 16, 8, 1, 256, 16, 16, start=[130, 0], n_tok=[16, 9]),
    "page_12_not_dividing_the_tile": lambda: _window_case(
        65, 2, 16, 8, 2, 128, 12, 20, start=[100, 7], n_tok=[16, 11]),
    "rows_past_the_tables_reach": lambda: _window_case(
        66, 2, 16, 8, 2, 128, 16, 4, start=[60, 10], n_tok=[16, 16]),
    # speculative verify windows at qwen3-8b's width: C = k+1 rows (k = 1
    # and 4; at a group of 4, 8 and 20 score rows, one block, 20 rows
    # straddling two 16-row tensor-core tiles), n_tok mixed 1..C, starts
    # mid-page
    "verify_qwen_width_k1": lambda: _window_case(
        80, 8, 2, 32, 8, 128, 16, 32, start=[13, 100, 7, 250, 31, 0, 64, 499],
        n_tok=[2, 1, 2, 1, 2, 2, 1, 2]),
    "verify_qwen_width_k4": lambda: _window_case(
        81, 8, 5, 32, 8, 128, 16, 32, start=[13, 100, 7, 250, 31, 3, 64, 490],
        n_tok=[5, 1, 3, 4, 2, 5, 1, 5]),
    # 64-row prefill windows and k = 4 verify windows at the MoE archs'
    # layouts: qwen3-moe-30b-a3b (H 32 / H_kv 4: group 8, 8 window rows a
    # block) and qwen2-moe-a2.7b (H 16 / H_kv 16: group 1), D 128
    "moe_qwen3_group_8_d128": lambda: _window_case(
        82, 4, 64, 32, 4, 128, 16, 64, start=[5, 100, 0, 937],
        n_tok=[64, 30, 0, 23]),
    "moe_qwen2_group_1_d128": lambda: _window_case(
        83, 4, 64, 16, 16, 128, 16, 64, start=[5, 100, 0, 937],
        n_tok=[64, 30, 0, 23]),
    "verify_moe_qwen3_k4": lambda: _window_case(
        84, 8, 5, 32, 4, 128, 16, 32, start=[13, 100, 7, 250, 31, 3, 64, 490],
        n_tok=[5, 1, 3, 4, 2, 5, 1, 5]),
    "verify_moe_qwen2_k4": lambda: _window_case(
        85, 8, 5, 16, 16, 128, 16, 32, start=[13, 100, 7, 250, 31, 3, 64, 490],
        n_tok=[5, 1, 3, 4, 2, 5, 1, 5]),
}
PREFILL_GPU_CASES = {**WINDOW_CASES, **PREFILL_EDGE_CASES}

# the edges of the f32 prefill body (token groups walking every other
# tile of 64 tokens, 32 at D = 256): page sizes 5 and 48 that do not
# divide the tile; an empty context (n_tok 0, and a window from position
# 0); rows past the table's n_slots * P reach (clamped); GQA groups 1, 4
# and 8; head dims 16 and 32 (the smoke configs), 128 (qwen3-8b) and 256;
# windows shorter than choose_block's rows; contexts long enough for both
# token groups to walk several tiles
F32_PREFILL_CASES = {
    "page_5_d128_g4": lambda: _window_case(
        70, 2, 16, 32, 8, 128, 5, 60, start=[201, 7], n_tok=[16, 11]),
    "page_48_d128_g4": lambda: _window_case(
        71, 2, 16, 8, 2, 128, 48, 8, start=[300, 30], n_tok=[16, 9]),
    "empty_context_d32": lambda: _window_case(
        72, 3, 8, 8, 2, 32, 16, 4, start=[0, 0, 9], n_tok=[0, 5, 0]),
    "rows_at_the_table_clamp": lambda: _window_case(
        73, 2, 16, 8, 2, 128, 16, 4, start=[60, 48], n_tok=[16, 16]),
    "group_1_d128": lambda: _window_case(
        74, 2, 32, 4, 4, 128, 16, 32, start=[400, 3], n_tok=[32, 20]),
    "group_8_d256_long": lambda: _window_case(
        75, 2, 8, 8, 1, 256, 16, 48, start=[700, 61], n_tok=[8, 5]),
    "d16_smoke_qwen": lambda: _window_case(
        76, 3, 3, 4, 2, 16, 4, 8, start=[0, 5, 29], n_tok=[3, 2, 0]),
    "d32_smoke_gemma": lambda: _window_case(
        77, 2, 3, 4, 1, 32, 4, 8, start=[1, 28], n_tok=[3, 3]),
    "window_below_the_block_g4": lambda: _window_case(
        78, 3, 3, 32, 8, 128, 16, 16, start=[130, 0, 255], n_tok=[3, 1, 2]),
    "qwen_width_to_1024": lambda: _window_case(
        79, 2, 64, 32, 8, 128, 16, 64, start=[960, 333], n_tok=[64, 50]),
}


# ======================================================================
# flash attention: q (B, H, T, D), k/v (B, H_kv, S, D)
# ======================================================================
def _flash_case(seed, b, h, hkv, t, s, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, t, d).astype(np.float32),
            rng.randn(b, hkv, s, d).astype(np.float32),
            rng.randn(b, hkv, s, d).astype(np.float32))


# name -> (shape args, attention options).  The first five are the
# reference's own cases (``tests/test_kernels.py``); the rest reach what
# the training path adds: gemma-2b's head dim 256 with a GQA group of 8,
# windowed rows whose first KV tiles are all masked, a ragged T that is
# no multiple of any tile, and a query range placed by q_offset with the
# columns cut at kv_len.
FLASH_CASES = {
    "causal_gqa": ((0, 2, 4, 2, 128, 128, 64), dict(causal=True)),
    "mqa_ragged_100": ((1, 1, 8, 1, 100, 100, 32), dict(causal=True)),
    "noncausal_mha": ((2, 2, 4, 4, 128, 128, 64), dict(causal=False)),
    "window_96": ((3, 1, 4, 2, 256, 256, 64), dict(causal=True, window=96)),
    "d128": ((4, 1, 2, 2, 64, 64, 128), dict(causal=True)),
    "gemma_d256_mqa_8": ((5, 1, 8, 1, 200, 200, 256), dict(causal=True)),
    "window_40_first_tiles_masked": ((6, 1, 4, 1, 230, 230, 64),
                                     dict(causal=True, window=40)),
    "q_offset_kv_len": ((7, 2, 4, 2, 48, 160, 64),
                        dict(causal=True, q_offset=100, kv_len=140)),
}
REF_FLASH_CASES = ("causal_gqa", "mqa_ragged_100", "noncausal_mha",
                   "window_96", "d128")

# the edges of the flash kernels' tiles (f32 64 x 64, bf16 128 x 64): T
# and S no multiple of either, D = 64 / 128 / 256, GQA groups 1 / 4 / 8,
# a window, q_offset with kv_len, and T below one tile
FLASH_EDGE_CASES = {
    "ragged_1000_d64_g4": ((20, 1, 4, 1, 1000, 1000, 64), dict(causal=True)),
    "ragged_777_d128_g1_noncausal": ((21, 1, 2, 2, 777, 777, 128),
                                     dict(causal=False)),
    "ragged_1000_d256_g8": ((22, 1, 8, 1, 1000, 1000, 256),
                            dict(causal=True)),
    "window_300_d128_g4": ((23, 1, 8, 2, 1000, 1000, 128),
                           dict(causal=True, window=300)),
    "q_offset_kv_len_d256_g1": ((24, 1, 2, 2, 777, 1000, 256),
                                dict(causal=True, q_offset=223, kv_len=950)),
    "t_below_one_tile_d64_g8": ((25, 2, 8, 1, 37, 50, 64),
                                dict(causal=False, kv_len=45)),
}
FLASH_GPU_CASES = {**FLASH_CASES, **FLASH_EDGE_CASES}

# (H, H_kv, D) of each model whose attention reaches the flash kernel
MODEL_HEADS = {"gemma-2b": (8, 1, 256), "qwen3-8b": (32, 8, 128),
               "gemma-2b-smoke": (4, 1, 32), "qwen3-8b-smoke": (4, 2, 16)}


def model_layout(heads, dt, device="cpu", t=130, seed=30):
    """q, k, v as ``models/flash.py`` hands them to the kernel: (B, H, T,
    D) / (B, H_kv, S, D) views of the projections' (b, t, h, d) tensors,
    q through its (b, t, h_kv, g, d) grouping."""
    h, hkv, d = heads
    rng = np.random.RandomState(seed)
    q, k, v = (_to_torch(rng.randn(1, t, n, d), dt).to(device)
               for n in (h, hkv, hkv))
    qg = q.reshape(1, t, hkv, h // hkv, d)
    return (qg.reshape(1, t, h, d).transpose(1, 2), k.transpose(1, 2),
            v.transpose(1, 2))


# ======================================================================
# on the GPU: the CUDA kernels against the plain versions
# ======================================================================
@pytest.fixture
def cuda_device():
    """The GPU, or a skip where there is none (decided at run time, not
    at collection, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the paged-attention kernels are "
                    "CUDA C++ with no CPU mode (run on the H100 host)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(DECODE_GPU_CASES))
def test_cuda_decode_kernel_matches_plain(cuda_device, case, dt):
    """Both decode bodies (partitions on the tensor cores in bf16, on the
    CUDA cores in f32) over the reference's corpus and each body's
    partition edges; length-0 rows exactly 0."""
    q, kp, vp, bt, lens = _tensors(DECODE_GPU_CASES[case](), dt, cuda_device)
    n = pa.LAUNCHES["paged_decode_attention"]
    got = pa.paged_decode_attention(q, kp, vp, bt, lens)
    assert pa.LAUNCHES["paged_decode_attention"] == n + 1
    want = pa.paged_decode_attention_ref(q, kp, vp, bt, lens)
    torch.cuda.synchronize()
    _close(got.cpu(), want.cpu().float().numpy(), dt, case)
    if dt == "bf16":
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        assert err <= SCALE_TOL * scale, (case, err, scale)
    for b in torch.nonzero(lens == 0).flatten().tolist():
        assert float(got[b].abs().max()) == 0.0


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(PREFILL_GPU_CASES))
def test_cuda_prefill_kernel_matches_plain(cuda_device, case, dt):
    """Both prefill bodies (bf16 tensor cores, f32 CUDA cores) over the
    reference's corpus and the bf16 body's tile edges; padded and
    inactive rows exactly 0."""
    q, kp, vp, bt, start, n_tok = _tensors(PREFILL_GPU_CASES[case](), dt,
                                           cuda_device)
    n = pa.LAUNCHES["paged_prefill_attention"]
    got = pa.paged_prefill_attention(q, kp, vp, bt, start, n_tok)
    assert pa.LAUNCHES["paged_prefill_attention"] == n + 1
    want = pa.paged_prefill_attention_ref(q, kp, vp, bt, start, n_tok)
    torch.cuda.synchronize()
    _close(got.cpu(), want.cpu().float().numpy(), dt, case)
    pad = torch.arange(q.shape[1], device=cuda_device)[None] \
        >= n_tok[:, None]
    assert torch.all(got[pad] == 0)


@pytest.mark.parametrize("case", sorted(F32_PREFILL_CASES))
def test_cuda_prefill_f32_body_matches_plain(cuda_device, case):
    """The f32 prefill body (CUDA cores, two token groups merged at the
    end) at the edges of its tiles; padded and inactive rows exactly 0,
    and only the f32 body's counter moves."""
    q, kp, vp, bt, start, n_tok = _tensors(F32_PREFILL_CASES[case](), "f32",
                                           cuda_device)
    n = dict(pa.LAUNCHES_BY_DTYPE)
    got = pa.paged_prefill_attention(q, kp, vp, bt, start, n_tok)
    n[("paged_prefill_attention", "f32")] += 1
    assert pa.LAUNCHES_BY_DTYPE == n
    want = pa.paged_prefill_attention_ref(q, kp, vp, bt, start, n_tok)
    torch.cuda.synchronize()
    _close(got.cpu(), want.cpu().numpy(), "f32", case)
    pad = torch.arange(q.shape[1], device=cuda_device)[None] \
        >= n_tok[:, None]
    assert torch.all(got[pad] == 0)


def test_cuda_prefill_f32_reads_strided_pool_views(cuda_device):
    """The engine hands the f32 body pool[:, 0|1, li] of a (n_pages, 2,
    layers, P, H_kv, D) pool: pages a whole layer stack apart."""
    rng = np.random.RandomState(80)
    b, c, h, hkv, d, p, slots, layers = 3, 16, 32, 8, 128, 16, 16, 3
    n_pages = b * slots + 1
    q = _to_torch(rng.randn(b, c, h, d)).to(cuda_device)
    pool = _to_torch(rng.randn(n_pages, 2, layers, p, hkv, d)).to(cuda_device)
    bt = _i32(rng.permutation(np.arange(1, n_pages)).reshape(b, slots)) \
        .to(cuda_device)
    start = _i32([100, 0, 233]).to(cuda_device)
    n_tok = _i32([16, 7, 0]).to(cuda_device)
    kp, vp = pool[:, 0, 1], pool[:, 1, 1]
    assert not kp.is_contiguous()
    got = pa.paged_prefill_attention(q, kp, vp, bt, start, n_tok)
    want = pa.paged_prefill_attention_ref(q, kp, vp, bt, start, n_tok)
    torch.cuda.synchronize()
    _close(got.cpu(), want.cpu().numpy(), "f32")
    assert float(got[2].abs().max()) == 0.0


def test_cuda_prefill_f32_raises_on_misaligned_rows(cuda_device):
    """The f32 body stages rows in 16-byte copies too: a pool off a
    16-byte boundary raises before any launch."""
    q, kp, vp, bt, start, n_tok = _tensors(WINDOW_CASES["gqa_4_1"](), "f32",
                                           cuda_device)
    n = dict(pa.LAUNCHES)
    pool = torch.zeros(kp.numel() + 1, device=cuda_device)
    odd = pool[1:].view(kp.shape)                 # starts 4 bytes off
    with pytest.raises(ValueError, match="16-byte"):
        pa.paged_prefill_attention(q, odd, vp, bt, start, n_tok)
    assert dict(pa.LAUNCHES) == n


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_cuda_decode_kernel_same_bits_on_every_call(cuda_device, dt):
    """Sequences over several partitions, merged by whichever block comes
    last: two calls give identical bits (the merge runs in partition
    order and each call leaves the tickets at zero), on the strided
    per-layer view of a three-layer pool, and match the plain version;
    only the dtype's body counts a launch."""
    q, pool, bt, lens = _tensors(_decode_pool(
        87, [777, 4096, 65, 0, 1, 512], slots=256, layers=3), dt,
        cuda_device)
    kp, vp = pool[:, 0, 2], pool[:, 1, 2]
    assert not kp.is_contiguous() and kp.stride(0) == 2 * 3 * 16 * 8 * 128
    n = dict(pa.LAUNCHES_BY_DTYPE)
    first = pa.paged_decode_attention(q, kp, vp, bt, lens)
    second = pa.paged_decode_attention(q, kp, vp, bt, lens)
    n[("paged_decode_attention", dt)] += 2
    assert pa.LAUNCHES_BY_DTYPE == n
    torch.cuda.synchronize()
    bits = torch.int32 if dt == "f32" else torch.int16
    assert torch.equal(first.view(bits), second.view(bits))
    want = pa.paged_decode_attention_ref(q, kp, vp, bt, lens)
    _close(first.cpu(), want.cpu().float().numpy(), dt)
    assert float(first[3].abs().max()) == 0.0


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_cuda_decode_raises_on_misaligned_bf16_rows(cuda_device, dt):
    """Both decode kernels (bf16, and f32 too) stage rows in 16-byte
    copies: a page pool that starts 8 bytes off a 16-byte boundary raises
    before any launch."""
    q, kp, vp, bt, lens = _tensors(_decode_full(88, [70, 3]), dt,
                                   cuda_device)
    n = dict(pa.LAUNCHES)
    off = 8 // kp.element_size()
    pool = torch.zeros(kp.numel() + off, dtype=kp.dtype, device=cuda_device)
    odd = pool[off:].view(kp.shape)               # starts 8 bytes off
    with pytest.raises(ValueError, match="16-byte"):
        pa.paged_decode_attention(q, odd, vp, bt, lens)
    assert dict(pa.LAUNCHES) == n


def test_cuda_kernel_path_never_runs_plain_versions(cuda_device,
                                                    monkeypatch):
    """On CUDA tensors with attn_impl="kernel", the engine goes through
    the kernels only: the plain versions are booby-trapped, and the
    launch counters equal n_layers x the steps of the run."""
    from repro_torch.launch import serve as launch
    from repro_torch.serve import Request

    def trap(*a, **k):
        raise AssertionError("plain attention ran on the CUDA path")

    monkeypatch.setattr(pa, "paged_decode_attention_ref", trap)
    monkeypatch.setattr(pa, "paged_prefill_attention_ref", trap)
    eng, cfg = launch.build_engine(config="smoke", dtype="bf16",
                                   device=cuda_device, page_tokens=4,
                                   n_pages=32, max_batch=3, prefill_chunk=3)
    pa.reset_launches()
    done = eng.run([Request(rid=i, prompt=p, max_new=5)
                    for i, p in enumerate(PROMPTS)], clock="tick")
    assert len(done) == 3
    assert pa.LAUNCHES == {
        "paged_decode_attention": cfg.n_layers * eng.steps["decode"],
        "paged_prefill_attention": cfg.n_layers * eng.steps["prefill"]}


def test_cuda_spec_streams_equal_plain_decode_streams(cuda_device):
    """Speculative decoding on the card, smoke config in f32: the spec
    streams (every decode token from a verify window through the prefill
    body) equal the non-spec streams (tokens from the decode body), and
    the prefill body launches n_layers x (prefill steps + verify ticks),
    the decode body never."""
    from repro_torch.launch import serve as launch
    from repro_torch.serve import Request

    def reqs():
        return [Request(rid=i, prompt=[5, 17, 42] * (4 - i), max_new=8)
                for i in range(3)]

    streams = {}
    for spec_k in (0, 2):
        eng, cfg = launch.build_engine(config="smoke", dtype="f32",
                                       device=cuda_device, page_tokens=4,
                                       n_pages=48, max_batch=3,
                                       prefill_chunk=4, spec_k=spec_k)
        pa.reset_launches()
        done = eng.run(reqs(), clock="tick")
        streams[spec_k] = {r.rid: list(r.out) for r in done}
        want = {("paged_prefill_attention", "f32"): cfg.n_layers * (
                    eng.steps["prefill"] + eng.steps["verify"]),
                ("paged_decode_attention", "f32"):
                    cfg.n_layers * eng.steps["decode"]}
        got = {k: v for k, v in pa.LAUNCHES_BY_DTYPE.items() if v}
        assert got == {k: v for k, v in want.items() if v}
        if spec_k:
            assert eng.steps["decode"] == 0 and eng.steps["verify"] > 0
            assert eng.metrics()["spec"]["drafted"] > 0
    assert streams[2] == streams[0]


# ======================================================================
# the copy engine and the combine kernel, and the pallas backend
# ======================================================================
from repro_torch import comm as C  # noqa: E402
from repro_torch.kernels import reduce_combine as rc  # noqa: E402
from repro_torch.kernels import symm_copy as sc  # noqa: E402
from repro_torch.launch import comm_bench as cb  # noqa: E402

COPY_DTYPES = [torch.float32, torch.bfloat16, torch.int8, torch.int32]


def _random_bits(n_bytes, device, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randint(0, 256, (n_bytes,), dtype=torch.uint8,
                         generator=g).to(device)


def _same_bytes(a, b):
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


@pytest.mark.parametrize("variant", sorted(sc.VARIANTS))
@pytest.mark.parametrize("dtype", COPY_DTYPES, ids=str)
def test_cuda_copy_kernel_matches_plain(cuda_device, dtype, variant):
    """Bit-exact on random bits (NaNs included), for sizes around the
    16-byte vector and the tiles, a 2-D shape, and misaligned views (the
    byte path)."""
    item = torch.empty((), dtype=dtype).element_size()
    for n in (1, 3, 4, 5, 31, 127, 4099, (1 << 20) + 3):
        x = _random_bits(n * item, cuda_device, n).view(dtype)
        n0 = sc.LAUNCHES["copy_blocked"]
        got = sc.copy_blocked(x, variant)
        assert sc.LAUNCHES["copy_blocked"] == n0 + 1
        torch.cuda.synchronize()
        assert got.data_ptr() != x.data_ptr()
        assert _same_bytes(got, sc.copy_blocked_ref(x, variant)), n
    x2 = _random_bits(33 * 37 * item, cuda_device, 7).view(dtype).view(33, 37)
    assert _same_bytes(sc.copy_blocked(x2, variant), x2)
    base = _random_bits(5000 * item + 64, cuda_device, 9).view(torch.uint8)
    for off in (1, 3, item, 16 + item):             # misaligned starts
        v = base[off:off + 4999 * item].view(dtype) if off % item == 0 \
            else base[off:off + 4999]
        assert v.data_ptr() % 16 != 0
        assert _same_bytes(sc.copy_blocked(v, variant), v.clone())
    torch.cuda.synchronize()


@pytest.mark.parametrize("variant", sorted(sc.VARIANTS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.int8], ids=str)
def test_cuda_copy_bulk_edges_match_plain(cuda_device, dtype, variant):
    """The bulk copy engine's edges, bit-exact: sizes at and around one
    ring stage and one tile, a size no multiple of 16, a source on a
    16-byte but not 128-byte boundary, and a payload larger than grid x
    ring (every block takes several laps)."""
    item = torch.empty((), dtype=dtype).element_size()
    r, c = sc.block_shape(variant, dtype)
    tile, stage = r * c * item, sc.STAGE_BYTES
    sizes = sorted({n for base in (stage, tile) for n in
                    (base - 16, base, base + 16, base + item)})
    sizes += [100000 * item + 3 * item, 40 * (1 << 20) + 5 * item]
    base = _random_bits(max(sizes) + 256, cuda_device, 17)
    for nbytes in sizes:
        for off in (0, 16):                  # 0 or 16 mod 128, co-aligned
            x = base[off:off + nbytes].view(dtype)
            assert x.data_ptr() % 16 == 0
            out = torch.empty_like(x)
            plan = sc.copy_plan(x.data_ptr(), out.data_ptr(), nbytes, tile,
                                torch.cuda.get_device_properties(
                                    cuda_device).multi_processor_count)
            assert plan[0] == "bulk" and plan[2] >= nbytes - 15
            key = (nbytes, str(dtype).removeprefix("torch."), variant)
            n0 = sc.LAUNCHES_BY_PAYLOAD[key]
            got = sc.copy_blocked(x, variant)
            assert sc.LAUNCHES_BY_PAYLOAD[key] == n0 + 1
            torch.cuda.synchronize()
            assert _same_bytes(got, sc.copy_blocked_ref(x, variant)), \
                (nbytes, off)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    ring = sc.build.load(sc.SOURCE).symm_copy_ring_bytes()
    assert max(sizes) > sms * ring           # more than grid x ring


def _same_bits(got, want):
    """Equal bit for bit (so -0.0 is not +0.0), save where both are NaN:
    which NaN an operation returns is not specified."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    if not got.is_floating_point():
        return torch.equal(got, want)
    bits = {2: torch.int16, 4: torch.int32}[got.element_size()]
    same = (got.view(bits) == want.view(bits)) | (got.isnan() & want.isnan())
    return bool(same.all())


@pytest.mark.parametrize("op", ["sum", "prod", "max", "min"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32], ids=str)
def test_cuda_combine_kernel_matches_plain(cuda_device, op, dtype):
    g = torch.Generator(device="cpu").manual_seed(11)
    for shape in ((1,), (7,), (4097,), (33, 37), (1 << 20,)):
        a = torch.randn(shape, generator=g) * 3
        b = torch.randn(shape, generator=g) * 3
        if dtype == torch.int32:
            a, b = (a * 1000).to(dtype), (b * 1000).to(dtype)
        else:
            a.view(-1)[::5] = float("nan")          # NaN must propagate
            b.view(-1)[::7] = float("nan")
            a.view(-1)[1::11] = -0.0
            a, b = a.to(dtype), b.to(dtype)
        a, b = a.to(cuda_device), b.to(cuda_device)
        views = [(a, b)]
        if a.numel() > 1:                                 # misaligned
            views.append((a.view(-1)[1:], b.view(-1)[1:]))
        for x, y in views:
            n0 = rc.LAUNCHES["combine_blocked"]
            got = rc.combine_blocked(x, y, op)
            assert rc.LAUNCHES["combine_blocked"] == n0 + 1
            want = rc.combine_blocked_ref(x, y, op)
            torch.cuda.synchronize()
            assert _same_bits(got, want), (op, shape)


# lengths around the combine's step (128 threads x 4 vector pairs):
# below one vector, one short of a step, a step and a few, no multiple
COMBINE_LENGTHS = [3, 7, 1023, 4095, 4096 * 3 + 5, 65536 + 13, 1 << 20]


@pytest.mark.parametrize("variant", sorted(rc.VARIANTS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32], ids=str)
def test_cuda_combine_edges_bit_exact(cuda_device, dtype, variant):
    """Every op, bit for bit, at lengths that are no multiple of the
    vectors in flight, below one vector, and 4 bytes off a 16-byte
    boundary (the element path), with NaN in a, in b and in both."""
    g = torch.Generator(device="cpu").manual_seed(12)
    for n in COMBINE_LENGTHS:
        a = torch.randn(n + 4, generator=g) * 3
        b = torch.randn(n + 4, generator=g) * 3
        if dtype == torch.int32:
            a, b = (a * 1000).to(dtype), (b * 1000).to(dtype)
        else:
            a[::5] = float("nan")
            b[::7] = float("nan")
            a, b = a.to(dtype), b.to(dtype)
        a, b = a.to(cuda_device), b.to(cuda_device)
        shift = 4 // a.element_size()                 # 4 bytes
        for x, y in ((a[:n], b[:n]), (a[shift:shift + n], b[shift:shift + n])):
            for op in ("sum", "prod", "max", "min"):
                got = rc.combine_blocked(x, y, op, variant)
                want = rc.combine_blocked_ref(x, y, op, variant)
                torch.cuda.synchronize()
                assert _same_bits(got, want), (op, n, x.data_ptr() % 16)


def test_cuda_combine_raises_on_what_it_does_not_take(cuda_device):
    f = torch.zeros(8, device=cuda_device)
    with pytest.raises(ValueError):
        rc.combine_blocked(f, torch.zeros(9, device=cuda_device))
    with pytest.raises(ValueError):
        rc.combine_blocked(f, f, "xor")
    with pytest.raises(TypeError):
        rc.combine_blocked(f.double(), f.double())
    with pytest.raises(ValueError):
        sc.copy_blocked(torch.zeros(8, 8, device=cuda_device).t())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_cuda_pallas_backend_equals_posh(cuda_device, dtype):
    """On the card the copy engine is an identity: every communicator op
    gives the posh result bit for bit, on both sides of every
    threshold."""
    posh = C.make_communicator("pe", size=8, backend="posh")
    pal = C.make_communicator("pe", size=8, backend="pallas")
    g = torch.Generator(device=cuda_device).manual_seed(5)
    for elems in (64, 1024, 4096, 8200, 1 << 18):
        x = torch.randn((8, elems), generator=g, device=cuda_device).to(dtype)
        for op in cb.COMM_OPS:
            assert torch.equal(cb.comm_call(pal, op, x),
                               cb.comm_call(posh, op, x)), (op, elems)
        m = x.reshape(8, 8, -1)
        assert torch.equal(pal.all_gather(m, axis=1, tiled=False),
                           posh.all_gather(m, axis=1, tiled=False))


def test_cuda_pallas_backend_never_takes_the_plain_copy(cuda_device,
                                                        monkeypatch):
    """The trap: with the plain copy replaced by a raise, the pallas
    backend on CUDA tensors runs, and the copy kernel's count rises by
    exactly the staged rounds at or above the stock threshold."""
    def trap(*a, **k):
        raise AssertionError("the plain copy ran on the CUDA comm path")

    monkeypatch.setattr(sc, "copy_blocked_ref", trap)
    pal = C.make_communicator("pe", size=8, backend="pallas")
    x = torch.randn((8, 1 << 18), device=cuda_device)     # 1 MiB per PE
    for op in cb.COMM_OPS:
        pal.reset_stats()
        n0 = sc.LAUNCHES["copy_blocked"]
        cb.comm_call(pal, op, x)
        torch.cuda.synchronize()
        (algo,) = pal.stats()[op]["algos"]
        want = cb.expected_copy_launches(op, algo, 8, 1 << 18, x.dtype)
        assert want > 0
        assert sc.LAUNCHES["copy_blocked"] - n0 == want, (op, algo)
    pal.reset_stats()
    n0 = sc.LAUNCHES["copy_blocked"]
    pal.psum(x)
    assert sc.LAUNCHES["copy_blocked"] - n0 == 2 * (8 - 1)    # ring psum


# ======================================================================
# the flash-attention kernel and the training path
# ======================================================================
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import flash as mflash  # noqa: E402


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(FLASH_GPU_CASES))
def test_cuda_flash_kernel_matches_plain(cuda_device, case, dt):
    """Output and log-sum-exp against the dense plain version, on the
    reference's cases and the two bodies' tile edges.  The q/out views
    are strided (the model's (b, t, h, d) layout)."""
    shape, opts = FLASH_GPU_CASES[case]
    q, k, v = (_to_torch(a, dt).to(cuda_device)
               for a in _flash_case(*shape))
    q = q.transpose(1, 2).contiguous().transpose(1, 2)    # (b, t, h, d) store
    n = fa.LAUNCHES["flash_attention"]
    out, lse = fa.flash_attention(q, k, v, **opts)
    assert fa.LAUNCHES["flash_attention"] == n + 1
    assert out.stride() == q.stride()
    want, want_lse = fa.flash_attention_ref(q, k, v, **opts)
    torch.cuda.synchronize()
    _close(out.cpu(), want.cpu().float().numpy(), dt, case)
    np.testing.assert_allclose(lse.cpu().numpy(), want_lse.cpu().numpy(),
                               atol=TOL[dt], rtol=TOL[dt], err_msg=case)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("model", sorted(MODEL_HEADS))
def test_cuda_flash_kernel_takes_the_models_layouts(cuda_device, model, dt):
    """The strided views ``models/flash.py`` passes are taken in place."""
    q, k, v = model_layout(MODEL_HEADS[model], dt, cuda_device)
    assert not q.is_contiguous()
    out, lse = fa.flash_attention(q, k, v, causal=True)
    want, want_lse = fa.flash_attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    _close(out.cpu(), want.cpu().float().numpy(), dt, model)
    np.testing.assert_allclose(lse.cpu().numpy(), want_lse.cpu().numpy(),
                               atol=TOL[dt], rtol=TOL[dt], err_msg=model)


def test_cuda_kernels_raise_on_misaligned_rows(cuda_device):
    """A start or a row stride the 16-byte copies cannot take raises
    before any launch: flash in both dtypes, bf16 prefill."""
    n = dict(fa.LAUNCHES), dict(pa.LAUNCHES)
    for dt in (torch.float32, torch.bfloat16):
        wide = torch.randn(1, 2, 8, 18, device=cuda_device).to(dt)
        rows = wide[..., :16]                     # rows 72 / 36 bytes apart
        flat = torch.randn(1 + 2 * 8 * 16, device=cuda_device).to(dt)
        shifted = flat[1:].view(1, 2, 8, 16)
        for q in (rows, shifted):
            with pytest.raises(ValueError, match="16-byte"):
                fa.flash_attention(q, q, q)
    case = _tensors(WINDOW_CASES["gqa_4_1"](), "bf16", cuda_device)
    q, kp, vp, bt, start, n_tok = case
    pool = torch.zeros(kp.numel() + 4, dtype=kp.dtype, device=cuda_device)
    odd = pool[4:].view(kp.shape)                 # starts 8 bytes off
    with pytest.raises(ValueError, match="16-byte"):
        pa.paged_prefill_attention(q, odd, vp, bt, start, n_tok)
    assert (dict(fa.LAUNCHES), dict(pa.LAUNCHES)) == n


def test_cuda_flash_kernel_raises_on_what_it_does_not_take(cuda_device):
    q = torch.randn(1, 2, 8, 16, device=cuda_device)
    k = torch.randn(1, 1, 8, 16, device=cuda_device)
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="head_dim"):
        big = torch.randn(1, 1, 8, 320, device=cuda_device)
        fa.flash_attention(big, big, big)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q[..., ::2], k[..., ::2], k[..., ::2])
    k2 = torch.randn(1, 2, 8, 16, device=cuda_device)
    with pytest.raises(ValueError, match="GQA"):
        fa.flash_attention(torch.randn(1, 3, 8, 16, device=cuda_device), k2,
                           k2)


@pytest.mark.parametrize("opts", [dict(causal=True),
                                  dict(causal=True, window=24),
                                  dict(causal=False)],
                         ids=["causal", "window", "noncausal"])
def test_cuda_autograd_kernel_path_matches_plain_path(cuda_device, opts):
    """blocked_attention with the kernel forward (and the plain blocked
    backward) against the all-plain path: outputs and q/k/v grads (f32;
    the two forwards differ only by summation order)."""
    rng = np.random.RandomState(8)
    b, t, h, hkv, d = 2, 150, 8, 2, 64
    base = [torch.from_numpy(rng.randn(*sh).astype(np.float32))
            .to(cuda_device) for sh in ((b, t, h, d), (b, t, hkv, d),
                                        (b, t, hkv, d))]
    dout = torch.from_numpy(rng.randn(b, t, h, d).astype(np.float32)) \
        .to(cuda_device)
    res = {}
    for impl in ("kernel", "ref"):
        q, k, v = (x.clone().requires_grad_(True) for x in base)
        n = fa.LAUNCHES["flash_attention"]
        out = mflash.blocked_attention(q, k, v, block_q=64, block_kv=32,
                                       impl=impl, **opts)
        assert fa.LAUNCHES["flash_attention"] == n + (impl == "kernel")
        out.backward(dout)
        res[impl] = [out.detach(), q.grad, k.grad, v.grad]
    for got, want in zip(res["kernel"], res["ref"]):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def _smoke_losses(arch, impl, device, steps=3):
    from repro_torch.launch.train import build_trainer
    tr = build_trainer(arch, smoke=True, device=device, attn_impl=impl,
                       microbatches=2)
    return [tr.step(s)["loss"] for s in range(steps)]


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen3-8b"])
def test_cuda_smoke_training_kernel_equals_plain(cuda_device, arch,
                                                 monkeypatch):
    """Three smoke-config steps on the card with the kernel forward and
    with the plain one: the same losses (f32; 1e-5 relative covers the
    forwards' summation order).  On the kernel path the plain forward is
    booby-trapped, and each layer's forward launches the kernel twice
    per microbatch (once more in the recompute under remat)."""
    plain = _smoke_losses(arch, "ref", cuda_device)

    def trap(*a, **k):
        raise AssertionError("the plain flash forward ran on the CUDA path")

    monkeypatch.setattr(fa, "flash_attention_ref", trap)
    monkeypatch.setattr(mflash, "_chunk_fwd", trap)
    fa.reset_launches()
    kernel = _smoke_losses(arch, "kernel", cuda_device)
    assert fa.LAUNCHES["flash_attention"] == 2 * 2 * 3 * 2  # L x mb x steps x 2
    np.testing.assert_allclose(kernel, plain, rtol=1e-5)
