"""repro_torch on the GPU: the CUDA paged-attention kernels against
their plain PyTorch versions over the reference's parity corpus
(mid-page starts, full final pages, padded and inactive rows, the verify
shape, GQA/MQA, f32/bf16, length 0), the edges of the bf16 prefill
kernel's tiles and verify windows at qwen3-8b's width, and the engine's
kernel path, speculative decoding and disaggregated cells included;
the copy and combine kernels and the pallas backend; the
flash-attention kernel against its plain version (its tile edges, the
models' layouts, the 16-byte row check), the autograd path through it,
and smoke-config training with it (the RWKV and Mamba-hybrid families
and minitron / danube too, and prefill past the sliding window then
decode; MoE training and TP training on the stacked team); and the
checkpoint slice on the card: the weight stream's
pinned rows and per-PE stages, a hot swap through the paged kernels
equal to a cold start, a train state's checkpoint restored onto the
card.

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
# no multiple of any tile, a query range placed by q_offset with the
# columns cut at kv_len, and cross attention's shape: non-causal, fewer
# query rows than a ragged KV length, at whisper's D 64 (group 1) and the
# vlm's D 128 (group 8).
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
    "cross_d64_t100_s150": ((8, 1, 4, 4, 100, 150, 64), dict(causal=False)),
    "cross_d128_g8_t72_s130": ((9, 1, 8, 1, 72, 130, 128),
                               dict(causal=False)),
}
REF_FLASH_CASES = ("causal_gqa", "mqa_ragged_100", "noncausal_mha",
                   "window_96", "d128", "cross_d64_t100_s150",
                   "cross_d128_g8_t72_s130")

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
    # cross attention at the paths' lengths: whisper's decoder (T 448 =
    # 3.5 bf16 q tiles) over 1500 encoder rows (23 x 64 + 28), the vlm's
    # 1024 text rows over 1601 image rows
    "xattn_448_1500_d64_g1": ((26, 1, 8, 8, 448, 1500, 64),
                              dict(causal=False)),
    "xattn_1024_1601_d128_g8": ((27, 1, 16, 2, 1024, 1601, 128),
                                dict(causal=False)),
}
FLASH_GPU_CASES = {**FLASH_CASES, **FLASH_EDGE_CASES}

# (H, H_kv, D) of each model whose attention reaches the flash kernel
MODEL_HEADS = {"gemma-2b": (8, 1, 256), "qwen3-8b": (32, 8, 128),
               "gemma-2b-smoke": (4, 1, 32), "qwen3-8b-smoke": (4, 2, 16),
               "h2o-danube-3-4b": (32, 8, 120), "zamba2-7b": (32, 32, 112),
               "minitron-4b": (24, 8, 128), "whisper-base": (8, 8, 64),
               "llama-3.2-vision-90b": (64, 8, 128)}
# the models whose cross attention reaches the kernel with T != S
CROSS_MODELS = ("whisper-base", "llama-3.2-vision-90b")


def model_layout(heads, dt, device="cpu", t=130, seed=30, s=None):
    """q, k, v as ``models/flash.py`` hands them to the kernel: (B, H, T,
    D) / (B, H_kv, S, D) views of the projections' (b, t, h, d) tensors
    (K/V of ``s`` rows, default ``t``: cross attention's are the encoder
    or image rows), q through its (b, t, h_kv, g, d) grouping."""
    h, hkv, d = heads
    rng = np.random.RandomState(seed)
    q, k, v = (_to_torch(rng.randn(1, n_rows, n, d), dt).to(device)
               for n, n_rows in ((h, t), (hkv, s or t), (hkv, s or t)))
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


@pytest.mark.parametrize("disagg,router,spec_k",
                         [("1+1", "host", 0), ("2+2", "amo", 2)])
def test_cuda_disagg_streams_equal_plain_streams(cuda_device, disagg, router,
                                                 spec_k):
    """Disaggregated cells on the card, smoke config in f32: the kernel
    path's streams equal the plain path's, the handoff drains by
    ``signal_wait_until`` alone, and the paged kernels launch n_layers x
    the steps summed over the cells (verify windows through the prefill
    body)."""
    from repro_torch.launch import serve as launch
    from repro_torch.serve import Request

    def reqs():
        return [Request(rid=i, prompt=[5, 17, 42] * (4 - i), max_new=8,
                        t_arrive=i) for i in range(4)]

    streams = {}
    for impl in ("ref", "kernel"):
        eng, cfg = launch.build_engine(config="smoke", dtype="f32",
                                       device=cuda_device, page_tokens=4,
                                       n_pages=48, max_batch=3,
                                       prefill_chunk=4, spec_k=spec_k,
                                       disagg=disagg, router=router,
                                       attn_impl=impl)
        pa.reset_launches()
        done = eng.run(reqs(), clock="tick")
        streams[impl] = {r.rid: list(r.out) for r in done}
        hs, steps = eng.stats(), eng.metrics()["steps"]
        assert hs["handoff_quiets"] == 0 and hs["router_quiets"] == 0
        assert hs["handoff_signals"] == hs["handoff_pages"] > 0
        assert hs["handoff_waits"] == hs["handoff_tickets"] == 4
        assert eng.hq.state["kv_mail"].device.type == "cuda"
        want = {("paged_prefill_attention", "f32"): cfg.n_layers * (
                    steps["prefill"] + steps["verify"]),
                ("paged_decode_attention", "f32"):
                    cfg.n_layers * steps["decode"]}
        got = {k: v for k, v in pa.LAUNCHES_BY_DTYPE.items() if v}
        if impl == "kernel":
            assert got == {k: v for k, v in want.items() if v}
            assert min(want.values()) > 0 or spec_k
        else:
            assert got == {}
        for e in eng.engines:
            assert e.kv.n_free() == e.kv.n_pages - 1 and not e.kv.tables
    assert streams["kernel"] == streams["ref"]


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


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("model", CROSS_MODELS)
def test_cuda_flash_kernel_takes_the_cross_layouts(cuda_device, model, dt):
    """Cross attention's views (K/V of 77 encoder / image rows, 130
    query rows), non-causal, in place."""
    q, k, v = model_layout(MODEL_HEADS[model], dt, cuda_device, s=77)
    out, lse = fa.flash_attention(q, k, v, causal=False)
    want, want_lse = fa.flash_attention_ref(q, k, v, causal=False)
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


# flash launches of 3 smoke steps in 2 microbatches: 2 attention layers x
# 2 under remat (dense), the hybrid's shared block twice a microbatch
# (not under remat, as the reference's), none in RWKV
A10_LAUNCHES = {"minitron-4b": 2 * 2 * 3 * 2, "h2o-danube-3-4b": 2 * 2 * 3 * 2,
                "zamba2-7b": 2 * 2 * 3, "rwkv6-3b": 0}


@pytest.mark.parametrize("arch", sorted(A10_LAUNCHES))
def test_cuda_a10_smoke_training_kernel_equals_plain(cuda_device, arch,
                                                     monkeypatch):
    """The RWKV and hybrid families and the new dense configs train on
    the card: three smoke steps with the kernel forward equal the plain
    forward's (rtol 1e-5), the kernel launched as many times as the
    layers, microbatches and remat say, the plain forward never."""
    plain = _smoke_losses(arch, "ref", cuda_device)

    def trap(*a, **k):
        raise AssertionError("the plain flash forward ran on the CUDA path")

    monkeypatch.setattr(fa, "flash_attention_ref", trap)
    monkeypatch.setattr(mflash, "_chunk_fwd", trap)
    fa.reset_launches()
    kernel = _smoke_losses(arch, "kernel", cuda_device)
    assert fa.LAUNCHES["flash_attention"] == A10_LAUNCHES[arch]
    np.testing.assert_allclose(kernel, plain, rtol=1e-5)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "zamba2-7b"])
def test_cuda_a10_prefill_kernel_equals_plain(cuda_device, arch, dt):
    """``lm.prefill`` past the smoke window (48 tokens, window 16) through
    the flash kernel equals the plain forward's within the dtype's
    tolerance; then ``decode_step`` runs on the card, the bf16 cache
    and all, its tokens inside the vocab."""
    from repro_torch.parallel import ParallelCtx
    cfg = tconfigs.get_smoke(arch)
    dtype = TDT[dt]
    params = lm.init(torch.Generator(device=cuda_device).manual_seed(0), cfg,
                     dtype=dtype, device=cuda_device)
    ids = torch.arange(48, device=cuda_device)[None].repeat(2, 1) % cfg.vocab
    apps = (cfg.n_layers // cfg.shared_attn_every if cfg.shared_attn_every
            else cfg.n_layers)
    out = {}
    for impl in ("kernel", "ref"):
        ctx = ParallelCtx(remat=False, attn_impl=impl, param_dtype=dtype,
                          compute_dtype=dtype)
        n = fa.LAUNCHES["flash_attention"]
        with torch.no_grad():
            out[impl] = lm.prefill(params, ids, ctx, cfg).float().cpu()
        launched = fa.LAUNCHES["flash_attention"] - n
        assert launched == (apps if impl == "kernel" else 0)
    scale = float(out["ref"].abs().max())
    np.testing.assert_allclose(out["kernel"].numpy(), out["ref"].numpy(),
                               rtol=TOL[dt], atol=TOL[dt] * scale)
    state = lm.init_decode_state(cfg, ctx, 2, 24, device=cuda_device)
    tok = ids[:, 0]
    with torch.no_grad():
        for _ in range(20):
            tok, state = lm.decode_step(params, tok, state, ctx, cfg)
    assert state["cache" if arch != "zamba2-7b" else "shared_cache"][
        "k"].dtype == torch.bfloat16
    assert bool(((tok >= 0) & (tok < cfg.padded_vocab(1))).all())


# flash launches of 3 smoke steps in 2 microbatches: whisper's 2 encoder
# layers (one self attention each) and 2 decoder layers (self and cross)
# all under remat, x 2; the vlm's 2 groups of a dense layer under remat
# (x 2) and a cross layer outside it (x 1), as the reference's scans
XATTN_LAUNCHES = {"whisper-base": (2 + 2 * 2) * 2 * 2 * 3,
                  "llama-3.2-vision-90b": (2 * 2 + 2) * 2 * 3}


def _xattn_losses(arch, impl, device, steps=3):
    """Three smoke steps through ``make_train_step`` on a batch with the
    family's ``frames`` / ``img_embeds`` (seeded), the vlm's gates set
    non-zero (0.5 / -0.7) so the cross layers count."""
    from repro_torch.parallel import ParallelCtx
    from repro_torch.models import registry
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.step import train_state_from
    cfg = tconfigs.get_smoke(arch)
    api = registry.build(cfg)
    ctx = ParallelCtx(remat=True, attn_impl=impl, param_dtype=torch.float32,
                      compute_dtype=torch.float32)
    params = api.init(torch.Generator(device=device).manual_seed(0), cfg,
                      device=device)
    if cfg.family == "vlm":
        params["cross"]["xgate"].fill_(0.5)
        params["cross"]["mgate"].fill_(-0.7)
    opt = AdamWConfig(lr=5e-3)
    state = train_state_from(params, ctx, opt)
    step = make_train_step(cfg, ctx, api, opt, microbatches=2)
    key, rows = (("frames", cfg.enc_frames) if cfg.family == "encdec"
                 else ("img_embeds", cfg.img_tokens))
    g = torch.Generator(device=device).manual_seed(1)
    out = []
    for _ in range(steps):
        batch = {"tokens": torch.randint(0, cfg.vocab, (4, cfg.max_seq + 1),
                                         generator=g, device=device),
                 key: torch.randn((4, rows, cfg.d_model), generator=g,
                                  device=device)}
        out.append(float(step(state, batch)[1]["loss"]))
    return out


@pytest.mark.parametrize("arch", sorted(XATTN_LAUNCHES))
def test_cuda_xattn_smoke_training_kernel_equals_plain(cuda_device, arch,
                                                       monkeypatch):
    """whisper and the vlm train on the card: three smoke steps with the
    kernel forward (cross attention's T != S, non-causal) equal the plain
    forward's (rtol 1e-5), the kernel launched as the layers,
    microbatches and remat say, the plain forward never."""
    plain = _xattn_losses(arch, "ref", cuda_device)

    def trap(*a, **k):
        raise AssertionError("the plain flash forward ran on the CUDA path")

    monkeypatch.setattr(fa, "flash_attention_ref", trap)
    monkeypatch.setattr(mflash, "_chunk_fwd", trap)
    fa.reset_launches()
    kernel = _xattn_losses(arch, "kernel", cuda_device)
    assert fa.LAUNCHES["flash_attention"] == XATTN_LAUNCHES[arch]
    np.testing.assert_allclose(kernel, plain, rtol=1e-5)


# ======================================================================
# the checkpoint slice on the card: the weight stream and checkpoints
# ======================================================================
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.ckpt import (Checkpointer, hotswap, load_checkpoint,  # noqa: E402
                              save_checkpoint)
from repro_torch.models import lm  # noqa: E402
from repro_torch.train import state_to_tree, tree  # noqa: E402


def _smoke_weights(device, seed, dtype=torch.float32):
    cfg = tconfigs.get_smoke("qwen3-8b")
    gen = torch.Generator(device=device).manual_seed(seed)
    return cfg, lm.init(gen, cfg, dtype=dtype, device=device)


def test_cuda_weight_streamer_stages_on_the_card(cuda_device):
    """On the card the packed rows are pinned host memory, each PE's stage
    its own allocation on the card, every batch landed through the side
    stream's copy; ``result()`` is the new weights bit for bit, as views
    of PE 0's stage."""
    _, params = _smoke_weights(cuda_device, 3, torch.bfloat16)
    st = hotswap.WeightStreamer(params, n_pe=2, chunk_rows=3,
                                row_bytes=1 << 12, device=cuda_device)
    assert st._rows.is_pinned() and st._rows.device.type == "cpu"
    stage = st.q.state[st.handle.name]
    assert [s.device.type for s in stage] == ["cuda", "cuda"]
    assert stage[0].data_ptr() != stage[1].data_ptr()
    while not st.step():
        pass
    out = st.result()
    lo, hi = stage[0].data_ptr(), stage[0].data_ptr() + stage[0].numel()
    for a, b in zip(tree.leaves(params), tree.leaves(out)):
        assert b.device.type == "cuda" and b.dtype == a.dtype
        assert torch.equal(a, b) and lo <= b.data_ptr() < hi
    assert st.extra_global_drains() == 0


def test_cuda_engine_hot_swap_is_cold_start_identical(cuda_device):
    """Smoke qwen3-8b in f32 on the card through the paged kernels: a
    swap streamed during a trace leaves that trace on the old weights,
    and the trace after the flip equals a cold engine's on the new
    weights."""
    cfg, old = _smoke_weights(cuda_device, 0)
    new = _smoke_weights(cuda_device, 7)[1]
    scfg = tserve.ServeConfig(page_tokens=4, n_pages=32, max_batch=3,
                              max_seq=32)

    def reqs(rids):
        return [tserve.Request(rid=r, max_new=6, prompt=[
            (7 * r + k) % cfg.vocab for k in range(5)]) for r in rids]

    def streams(done):
        return {r.rid: list(r.out) for r in done}

    eng = tserve.ServeEngine(old, cfg, scfg, device=cuda_device)
    eng.begin_hot_swap(new, chunk_rows=2, row_bytes=1 << 12)
    pa.reset_launches()
    pre = streams(eng.run(reqs(range(3)), clock="tick"))
    assert eng.swap_stats["flips"] == 1
    assert eng.swap_stats["swap_extra_quiets"] == 0
    assert min(pa.LAUNCHES.values()) > 0
    eng.reset_metrics()
    post = streams(eng.run(reqs(range(10, 13)), clock="tick"))
    cold = tserve.ServeEngine(new, cfg, scfg, device=cuda_device)
    assert post == streams(cold.run(reqs(range(10, 13)), clock="tick"))
    ref = tserve.ServeEngine(old, cfg, scfg, device=cuda_device)
    assert pre == streams(ref.run(reqs(range(3)), clock="tick"))


def test_cuda_checkpoint_round_trip(cuda_device, tmp_path):
    """A smoke trainer's state on the card: saved in the reference's
    layout and restored into another trainer on the card, bit for bit;
    the next step's loss agrees (1e-5 relative, as the smoke training
    test above); a tree on the card loads back onto the card."""
    from repro_torch.launch.train import build_trainer
    a = build_trainer("gemma-2b", smoke=True, device=cuda_device)
    a.step(0)
    ck = Checkpointer(str(tmp_path / "ck"))
    a.save(ck, 1)
    ck.wait()
    b = build_trainer("gemma-2b", smoke=True, device=cuda_device, seed=4)
    assert b.restore(ck) == 1
    for x, y in zip(tree.leaves(state_to_tree(a.state)),
                    tree.leaves(state_to_tree(b.state))):
        assert x.device.type == y.device.type == "cuda"
        assert torch.equal(x, y)
    np.testing.assert_allclose(b.step(1)["loss"], a.step(1)["loss"],
                               rtol=1e-5)
    t = {"w": torch.arange(6.0, device=cuda_device),
         "n": torch.ones(3, dtype=torch.int32, device=cuda_device)}
    save_checkpoint(str(tmp_path / "t"), 2, t)
    loaded, step = load_checkpoint(str(tmp_path / "t"), t)
    assert step == 2
    for x, y in zip(tree.leaves(t), tree.leaves(loaded)):
        assert y.device.type == "cuda" and torch.equal(x, y)


# ======================================================================
# tensor-parallel serving on the stacked team
# ======================================================================
from repro_torch.core.heap import SymmetricHeap  # noqa: E402
from repro_torch.parallel import ParallelCtx  # noqa: E402


@pytest.mark.parametrize("backend", ["xla", "posh", "pallas"])
def test_cuda_tp_engine_folds_every_pe_into_one_launch(cuda_device,
                                                       backend):
    """Smoke qwen3-8b in f32 at TP 4 with two replicas on the card: the
    paged kernels launch once per layer per step for all 8 PEs (not once
    per PE), the streams equal the plain versions', and the pallas
    backend stages its psum rounds through the copy kernel exactly as
    the schedules' rounds say (xla and posh never launch it)."""
    cfg, params = _smoke_weights(cuda_device, 0)
    ctx = ParallelCtx(tp_size=4, backend=backend)
    streams = {}
    for impl in ("kernel", "ref"):
        scfg = tserve.ServeConfig(page_tokens=4, n_pages=24, max_batch=3,
                                  max_seq=32, prefill_chunk=3,
                                  attn_impl=impl)
        kv = tserve.PagedKVCache(
            SymmetricHeap(("data", "model")),
            n_layers=cfg.n_layers, kv_heads=cfg.kv_per_rank(4),
            head_dim=cfg.head_dim, n_pages=24, page_tokens=4)
        ex = tserve.StackedExec(params, cfg, ctx, scfg, kv, cuda_device,
                                replicas=2)
        eng = tserve.ServeEngine(params, cfg, scfg, ctx=ctx, exec_=ex,
                                 kv=kv, device=cuda_device)
        pa.reset_launches()
        sc.reset_launches()
        ctx.tp_comm.reset_stats()
        done = eng.run([tserve.Request(rid=i, prompt=list(p), max_new=6)
                        for i, p in enumerate(PROMPTS)], clock="tick")
        torch.cuda.synchronize()
        streams[impl] = {r.rid: list(r.out) for r in done}
        n = cfg.n_layers if impl == "kernel" else 0
        assert dict(pa.LAUNCHES) == {
            "paged_decode_attention": n * eng.steps["decode"],
            "paged_prefill_attention": n * eng.steps["prefill"]}
        want = 0
        if backend == "pallas":
            for (op, nbytes, dtype, algo), calls in \
                    ctx.tp_comm.payload_stats().items():
                want += calls * cb.expected_copy_launches(
                    "all_gather" if op == "top_k_merge" else op, algo, 4,
                    nbytes // 4, torch.float32)
        assert sc.LAUNCHES["copy_blocked"] == want
        assert (want > 0) == (backend == "pallas")
    assert streams["kernel"] == streams["ref"]


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "qwen2-moe-a2.7b"])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("dispatch", ["einsum", "alltoall"])
def test_cuda_moe_tp_engine_kernel_streams_equal_plain(cuda_device, arch, tp,
                                                       dispatch):
    """The smoke MoE configs in f32 at TP 2 and 4 with two replicas on the
    card, under each MoE dispatch (posh): the kernel streams equal the
    plain versions', the paged kernels launch once per layer per step
    for every PE, and the step's collectives are the dispatch's (einsum:
    a psum of the routed experts a layer; alltoall: two all_to_all)."""
    cfg = tconfigs.get_smoke(arch)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = lm.init(gen, cfg, device=cuda_device)
    ctx = ParallelCtx(tp_size=tp, backend="posh", moe_dispatch=dispatch)
    streams = {}
    for impl in ("kernel", "ref"):
        scfg = tserve.ServeConfig(page_tokens=4, n_pages=24, max_batch=3,
                                  max_seq=32, prefill_chunk=3,
                                  attn_impl=impl)
        kv = tserve.PagedKVCache(
            SymmetricHeap(("data", "model")),
            n_layers=cfg.n_layers, kv_heads=cfg.kv_per_rank(tp),
            head_dim=cfg.head_dim, n_pages=24, page_tokens=4)
        ex = tserve.StackedExec(params, cfg, ctx, scfg, kv, cuda_device,
                                replicas=2)
        eng = tserve.ServeEngine(params, cfg, scfg, ctx=ctx, exec_=ex,
                                 kv=kv, device=cuda_device)
        pa.reset_launches()
        ctx.tp_comm.reset_stats()
        done = eng.run([tserve.Request(rid=i, prompt=list(p), max_new=6)
                        for i, p in enumerate(PROMPTS)], clock="tick")
        torch.cuda.synchronize()
        streams[impl] = {r.rid: list(r.out) for r in done}
        n = cfg.n_layers if impl == "kernel" else 0
        assert dict(pa.LAUNCHES) == {
            "paged_decode_attention": n * eng.steps["decode"],
            "paged_prefill_attention": n * eng.steps["prefill"]}
        st, steps = ctx.tp_comm.stats(), sum(eng.steps.values())
        per_layer = 1 + bool(cfg.moe.shared_ff) + (dispatch == "einsum")
        assert st["psum"]["calls"] == steps * (1 + per_layer * cfg.n_layers)
        assert st.get("all_to_all", {}).get("calls", 0) == \
            (2 * cfg.n_layers * steps if dispatch == "alltoall" else 0)
    assert streams["kernel"] == streams["ref"]


# ======================================================================
# data-parallel training on the stacked team
# ======================================================================
def _dp_run(arch, device, backend, impl="kernel", steps=3, **kw):
    """Smoke ``arch`` in f32 at dp 2 (2 microbatches a replica) for
    ``steps`` steps: losses and grad norms, the final parameters, and
    the DP communicator."""
    from repro_torch.launch.train import build_trainer
    tr = build_trainer(arch, smoke=True, device=device, attn_impl=impl,
                       microbatches=2, dp_size=2, backend=backend, **kw)
    tr.ctx.dp_comm.reset_stats()
    out = [tr.step(s) for s in range(steps)]
    torch.cuda.synchronize()
    return ([(m["loss"], m["grad_norm"]) for m in out],
            [p.detach().clone() for p in tree.leaves(tr.state["params"])],
            tr.ctx.dp_comm)


def _staged_rounds(comm) -> int:
    total = 0
    for (op, nbytes, dtype, algo), calls in comm.payload_stats().items():
        dt = getattr(torch, dtype)
        total += calls * cb.expected_copy_launches(
            op, algo, comm.size, nbytes // dt.itemsize, dt)
    return total


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen3-8b"])
@pytest.mark.parametrize("how", [{}, {"bucket_bytes": 1 << 20,
                                      "overlap_grad_sync": True}])
def test_cuda_dp_training_kernel_equals_plain(cuda_device, arch, how,
                                              monkeypatch):
    """DP 2 on the card: the kernel forward's losses equal the plain
    forward's (rtol 1e-5, as at dp = 1); the flash kernel launches twice
    per layer per microbatch per replica per step (the recompute under
    remat), and the plain forward never runs on the kernel path; pallas
    equals posh bit for bit, its copy launches exactly the staged rounds
    of the DP communicator's calls (posh launches none)."""
    plain = _dp_run(arch, cuda_device, "posh", impl="ref", **how)[0]

    def trap(*a, **k):
        raise AssertionError("the plain flash forward ran on the CUDA path")

    monkeypatch.setattr(fa, "flash_attention_ref", trap)
    monkeypatch.setattr(mflash, "_chunk_fwd", trap)
    runs = {}
    for backend in ("posh", "pallas"):
        fa.reset_launches()
        sc.reset_launches()
        runs[backend] = _dp_run(arch, cuda_device, backend, **how)
        cfg = tconfigs.get_smoke(arch)
        assert fa.LAUNCHES["flash_attention"] == 2 * cfg.n_layers * 2 * 2 * 3
        want = _staged_rounds(runs[backend][2]) if backend == "pallas" else 0
        assert sc.LAUNCHES["copy_blocked"] == want
        assert (want > 0) == (backend == "pallas")
    np.testing.assert_allclose(runs["posh"][0], plain, rtol=1e-5)
    assert runs["pallas"][0] == runs["posh"][0]
    for a, b in zip(runs["pallas"][1], runs["posh"][1]):
        assert torch.equal(a, b)


# MoE training (tp = 1) and TP training (the stacked team, TP 4, sequence
# parallelism) at the smoke size: (arch, tp, moe_dispatch)
TRAIN_TP_CASES = [("qwen3-moe-30b-a3b", 1, "einsum"),
                  ("qwen2-moe-a2.7b", 1, "einsum"),
                  ("qwen3-8b", 4, "einsum"),
                  ("qwen3-moe-30b-a3b", 4, "einsum"),
                  ("qwen2-moe-a2.7b", 4, "alltoall")]


def _tp_losses(arch, tp, dispatch, impl, device):
    from repro_torch.launch.train import build_trainer
    tr = build_trainer(arch, smoke=True, device=device, tp_size=tp,
                       moe_dispatch=dispatch, attn_impl=impl,
                       global_batch=4, backend="posh")
    return [tr.step(s)["loss"] for s in range(3)]


@pytest.mark.parametrize("arch,tp,dispatch", TRAIN_TP_CASES)
def test_cuda_moe_and_tp_training_kernel_equals_plain(cuda_device, arch, tp,
                                                      dispatch, monkeypatch):
    """MoE training and TP training on the card: three smoke steps with
    the kernel forward equal the plain forward's (rtol 1e-5); the kernel
    launches once a layer a step for every PE together (x 2 under
    remat), the plain forward never on the kernel path."""
    plain = _tp_losses(arch, tp, dispatch, "ref", cuda_device)

    def trap(*a, **k):
        raise AssertionError("the plain flash forward ran on the CUDA path")

    monkeypatch.setattr(fa, "flash_attention_ref", trap)
    monkeypatch.setattr(mflash, "_chunk_fwd", trap)
    fa.reset_launches()
    kernel = _tp_losses(arch, tp, dispatch, "kernel", cuda_device)
    assert fa.LAUNCHES["flash_attention"] == \
        tconfigs.get_smoke(arch).n_layers * 2 * 3
    np.testing.assert_allclose(kernel, plain, rtol=1e-5)


# the stacked TP layout's per-PE query offsets: (seed, PEs, rows a PE, H,
# H_kv, rows of queries a PE, D) and options; batch row i's queries at
# q_offset + (i // rows) * (queries a PE), against the gathered K/V
PE_FLASH_CASES = {
    "ctx_tp4_d128_g3": ((40, 4, 2, 6, 2, 64, 128), dict(causal=True)),
    "ctx_tp16_ragged_28_d64": ((41, 16, 1, 8, 8, 28, 64), dict(causal=True)),
    "ctx_tp4_window_50_d112": ((42, 4, 2, 8, 8, 72, 112),
                               dict(causal=True, window=50)),
    "ctx_tp8_q_offset_d64": ((43, 8, 1, 4, 2, 40, 64),
                             dict(causal=True, q_offset=7)),
}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(PE_FLASH_CASES))
def test_cuda_flash_kernel_per_pe_offsets(cuda_device, case, dt):
    """ONE launch over every PE's rows, each at its PE's causal offset:
    equal to the plain version (output and log-sum-exp) and, bit for
    bit, to one launch per PE at that PE's offset."""
    (seed, tp, rows, h, hkv, t, d), opts = PE_FLASH_CASES[case]
    q, k, v = (_to_torch(a, dt).to(cuda_device)
               for a in _flash_case(seed, tp * rows, h, hkv, t, tp * t, d))
    q = q.transpose(1, 2).contiguous().transpose(1, 2)    # (b, t, h, d) store
    kw = dict(opts, pe_rows=rows, pe_stride=t)
    n = fa.LAUNCHES["flash_attention"]
    out, lse = fa.flash_attention(q, k, v, **kw)
    assert fa.LAUNCHES["flash_attention"] == n + 1
    want, want_lse = fa.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    _close(out.cpu(), want.cpu().float().numpy(), dt, case)
    np.testing.assert_allclose(lse.cpu().numpy(), want_lse.cpu().numpy(),
                               atol=TOL[dt], rtol=TOL[dt], err_msg=case)
    for r in range(tp):
        sl = slice(r * rows, (r + 1) * rows)
        o_r, l_r = fa.flash_attention(
            q[sl], k[sl], v[sl], **dict(opts, q_offset=opts.get(
                "q_offset", 0) + r * t))
        assert torch.equal(o_r, out[sl]) and torch.equal(l_r, lse[sl]), r


TP_FAMILY_LAUNCHES = {"minitron-4b": 2 * 2 * 3, "zamba2-7b": 2 * 3,
                      "rwkv6-3b": 0}


@pytest.mark.parametrize("arch", sorted(TP_FAMILY_LAUNCHES))
def test_cuda_tp_families_training_kernel_equals_plain(cuda_device, arch,
                                                       monkeypatch):
    """TP 4 training of the families A10's last slice brought (minitron's
    6 heads: the ctx layout; zamba2's shared block; rwkv6 without
    attention): three smoke steps with the kernel forward equal the
    plain forward's (rtol 1e-5); the kernel launches once a layer (an
    application of the shared block) a step for every PE together."""
    plain = _tp_losses(arch, 4, "einsum", "ref", cuda_device)

    def trap(*a, **k):
        raise AssertionError("the plain flash forward ran on the CUDA path")

    monkeypatch.setattr(fa, "flash_attention_ref", trap)
    monkeypatch.setattr(mflash, "_chunk_fwd", trap)
    fa.reset_launches()
    kernel = _tp_losses(arch, 4, "einsum", "kernel", cuda_device)
    assert fa.LAUNCHES["flash_attention"] == TP_FAMILY_LAUNCHES[arch]
    np.testing.assert_allclose(kernel, plain, rtol=1e-5)
