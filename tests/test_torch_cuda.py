"""repro_torch on the GPU: the CUDA paged-attention kernels against
their plain PyTorch versions over the reference's parity corpus
(mid-page starts, full final pages, padded and inactive rows, the verify
shape, GQA/MQA, f32/bf16, length 0), and the engine's kernel path.

Every test here needs a CUDA GPU and skips without one (the kernels are
CUDA C++ with no CPU mode); on the H100 host:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

This file imports no JAX, so it runs where JAX is not installed; the
cases are shared with ``test_torch_kernels.py``, which holds the
plain versions against the JAX oracles on the CPU.

Tolerances: f32 1e-5 (the same masked softmax in f32, summed in another
order); bf16 3e-2 (the reference's own bf16 window tolerance: both
sides read the same bf16 inputs, accumulate in f32 and round the output
to bf16 once).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import paged_attention as pa

torch.set_num_threads(2)

TOL = {"f32": 1e-5, "bf16": 3e-2}
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
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_cuda_decode_kernel_matches_plain(cuda_device, case, dt):
    q, kp, vp, bt, lens = _tensors(DECODE_CASES[case](), dt, cuda_device)
    n = pa.LAUNCHES["paged_decode_attention"]
    got = pa.paged_decode_attention(q, kp, vp, bt, lens)
    assert pa.LAUNCHES["paged_decode_attention"] == n + 1
    want = pa.paged_decode_attention_ref(q, kp, vp, bt, lens)
    torch.cuda.synchronize()
    _close(got.cpu(), want.cpu().float().numpy(), dt, case)
    for b in torch.nonzero(lens == 0).flatten().tolist():
        assert float(got[b].abs().max()) == 0.0


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_cuda_prefill_kernel_matches_plain(cuda_device, case, dt):
    q, kp, vp, bt, start, n_tok = _tensors(WINDOW_CASES[case](), dt,
                                           cuda_device)
    got = pa.paged_prefill_attention(q, kp, vp, bt, start, n_tok)
    want = pa.paged_prefill_attention_ref(q, kp, vp, bt, start, n_tok)
    torch.cuda.synchronize()
    _close(got.cpu(), want.cpu().float().numpy(), dt, case)
    pad = torch.arange(q.shape[1], device=cuda_device)[None] \
        >= n_tok[:, None]
    assert torch.all(got[pad] == 0)


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
