"""repro_torch paged attention: the plain PyTorch versions against the
JAX reference's oracles (``paged_decode_attention_ref`` /
``paged_prefill_attention_ref``) and its Pallas kernels in interpret
mode, over the reference's own parity corpus (mid-page starts, full
final pages, padded and inactive rows, the verify shape, GQA/MQA,
f32/bf16, length 0 — the cases of ``test_torch_cuda.py``, which holds
the CUDA kernels against the same plain versions on the GPU); and the
wrapper's device routing.

Tolerances: f32 1e-5 (the same masked softmax in f32, summed in another
order); bf16 3e-2 (the reference's own bf16 window tolerance: both
sides read the same bf16 inputs, accumulate in f32 and round the output
to bf16 once).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as jpa
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from test_torch_cuda import (DECODE_CASES, FLASH_CASES, MODEL_HEADS,
                             REF_FLASH_CASES, TDT, WINDOW_CASES, _close,
                             _flash_case, _i32, _paged_case, _to_torch,
                             model_layout)

torch.set_num_threads(2)

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_plain_matches_jax_oracle(case, dt):
    q, kp, vp, bt, lens = DECODE_CASES[case]()
    want = jpa.paged_decode_attention_ref(
        jnp.asarray(q, JDT[dt]), jnp.asarray(kp, JDT[dt]),
        jnp.asarray(vp, JDT[dt]), jnp.asarray(bt), jnp.asarray(lens))
    got = pa.paged_decode_attention(_to_torch(q, dt), _to_torch(kp, dt),
                                    _to_torch(vp, dt), _i32(bt), _i32(lens))
    assert got.dtype == TDT[dt]
    _close(got, want, dt, case)
    for b in np.flatnonzero(lens == 0):      # inactive -> exact zeros
        assert float(got[b].abs().max()) == 0.0


@pytest.mark.parametrize("case", ["mixed_lengths", "gqa_6_2"])
def test_decode_plain_matches_pallas_kernel_interpret(case):
    q, kp, vp, bt, lens = DECODE_CASES[case]()
    want = jpa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(lens), interpret=True)
    got = pa.paged_decode_attention_ref(_to_torch(q), _to_torch(kp),
                                        _to_torch(vp), _i32(bt), _i32(lens))
    _close(got, want, "f32", case)


def test_decode_reads_strided_pool_view():
    """The engine hands the kernels ``pool[:, 0|1, li]`` — a strided view
    of the (n_pages, 2, L, P, kvh, dh) pool; the result must equal the
    contiguous pages'."""
    q, kp, vp, bt, lens = _paged_case(seed=7)
    n_pages, P, hkv, d = kp.shape
    pool = torch.zeros((n_pages, 2, 3, P, hkv, d))
    pool[:, 0, 1] = _to_torch(kp)
    pool[:, 1, 1] = _to_torch(vp)
    kview, vview = pool[:, 0, 1], pool[:, 1, 1]
    assert not kview.is_contiguous()
    got = pa.paged_decode_attention(_to_torch(q), kview, vview, _i32(bt),
                                    _i32(lens))
    want = pa.paged_decode_attention(_to_torch(q), _to_torch(kp),
                                     _to_torch(vp), _i32(bt), _i32(lens))
    assert torch.equal(got, want)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_prefill_plain_matches_jax_oracle(case, dt):
    q, kp, vp, bt, start, n_tok = WINDOW_CASES[case]()
    want = jpa.paged_prefill_attention_ref(
        jnp.asarray(q, JDT[dt]), jnp.asarray(kp, JDT[dt]),
        jnp.asarray(vp, JDT[dt]), jnp.asarray(bt), jnp.asarray(start),
        jnp.asarray(n_tok))
    got = pa.paged_prefill_attention(_to_torch(q, dt), _to_torch(kp, dt),
                                     _to_torch(vp, dt), _i32(bt),
                                     _i32(start), _i32(n_tok))
    assert got.dtype == TDT[dt]
    _close(got, want, dt, case)
    pad = np.arange(q.shape[1])[None] >= n_tok[:, None]
    assert np.all(got.float().numpy()[pad] == 0.0)    # exact zeros


@pytest.mark.parametrize("case,block_q", [("midpage_starts_a", None),
                                          ("padded_and_inactive_rows", None),
                                          ("ragged_window_13", 8)])
def test_prefill_plain_matches_pallas_kernel_interpret(case, block_q):
    q, kp, vp, bt, start, n_tok = WINDOW_CASES[case]()
    want = jpa.paged_prefill_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(start), jnp.asarray(n_tok), block_q=block_q,
        interpret=True)
    got = pa.paged_prefill_attention_ref(_to_torch(q), _to_torch(kp),
                                         _to_torch(vp), _i32(bt),
                                         _i32(start), _i32(n_tok))
    _close(got, want, "f32", case)


def test_prefill_window_matches_per_position_decode():
    """The window equals C per-position decode calls (same mask, same
    scale), padded rows zero — in the port, on its own plain versions."""
    rng = np.random.RandomState(5)
    B, C, H, Hkv, D, P, n_pages = 3, 4, 4, 2, 16, 4, 10
    q = _to_torch(rng.randn(B, C, H, D))
    kp = _to_torch(rng.randn(n_pages, P, Hkv, D))
    vp = _to_torch(rng.randn(n_pages, P, Hkv, D))
    bt = _i32([[1, 2, 0, 0], [3, 4, 5, 0], [6, 7, 8, 9]])
    start, n_tok = _i32([0, 4, 2]), _i32([4, 3, 0])
    out = ops.paged_prefill_attention(q, kp, vp, bt, start, n_tok,
                                      impl="kernel")
    for b in range(B):
        for j in range(C):
            if j >= int(n_tok[b]):
                assert float(out[b, j].abs().max()) == 0.0
                continue
            lens = torch.zeros(B, dtype=torch.int32)
            lens[b] = int(start[b]) + j + 1
            ref = ops.paged_attention(q[:, j].contiguous(), kp, vp, bt, lens,
                                      impl="ref")
            torch.testing.assert_close(out[b, j], ref[b], atol=1e-6,
                                       rtol=1e-6)


# ======================================================================
# wrapper routing
# ======================================================================
def test_wrappers_use_plain_version_only_for_cpu_tensors(monkeypatch):
    """CPU tensors take the plain version without touching the build or
    the launch counters; any other device goes to the kernel path, which
    raises for a non-CUDA tensor — it never falls back to the plain
    version."""
    q, kp, vp, bt, lens = _paged_case()
    before = dict(pa.LAUNCHES)
    monkeypatch.setattr(pa.build, "load", lambda *a: pytest.fail(
        "CPU tensors must not build or load the CUDA library"))
    pa.paged_decode_attention(_to_torch(q), _to_torch(kp), _to_torch(vp),
                              _i32(bt), _i32(lens))
    assert pa.LAUNCHES == before

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran for a non-CPU tensor")

    monkeypatch.setattr(pa, "paged_decode_attention_ref", no_plain)
    monkeypatch.setattr(pa, "paged_prefill_attention_ref", no_plain)
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        pa.paged_decode_attention(torch.empty(3, 4, 16, **meta),
                                  torch.empty(10, 4, 2, 16, **meta),
                                  torch.empty(10, 4, 2, 16, **meta),
                                  torch.empty(3, 3, dtype=torch.int32, **meta),
                                  torch.empty(3, dtype=torch.int32, **meta))
    with pytest.raises(ValueError, match="CUDA tensors"):
        pa.paged_prefill_attention(torch.empty(3, 8, 4, 16, **meta),
                                   torch.empty(10, 4, 2, 16, **meta),
                                   torch.empty(10, 4, 2, 16, **meta),
                                   torch.empty(3, 3, dtype=torch.int32,
                                               **meta),
                                   torch.empty(3, dtype=torch.int32, **meta),
                                   torch.empty(3, dtype=torch.int32, **meta))


def test_ops_impl_switch_validates():
    q, kp, vp, bt, lens = (_to_torch(a) if a.dtype == np.float32 else _i32(a)
                           for a in _paged_case())
    with pytest.raises(ValueError, match="impl"):
        ops.paged_attention(q, kp, vp, bt, lens, impl="flash")
    torch.testing.assert_close(ops.paged_attention(q, kp, vp, bt, lens),
                               ops.paged_attention(q, kp, vp, bt, lens,
                                                   impl="ref"))


def test_choose_block_fits_the_warps_rows():
    assert [pa.choose_block(w, 4) for w in (1, 3, 16, 64, 4096)] == \
        [1, 3, 16, 16, 16]
    assert pa.choose_block(64, 8) == 8 and pa.choose_block(64, 1) == 16
    for g in range(1, pa.MAX_GROUP + 1):
        assert pa.choose_block(64, g) * g <= pa.MAX_WINDOW_ROWS


def _partition_tokens(part, length, n_slots, page_tokens, tokens):
    """The tokens block ``part`` of a decode body with ``tokens``-token
    partitions takes for a sequence of ``length`` (the kernel's walk: the
    length clamped to the table's reach, ``tokens`` a block, none past
    the length)."""
    length = max(0, min(length, n_slots * page_tokens))
    t0 = part * tokens
    return range(t0, max(t0, min(t0 + tokens, length)))


# the partition of each decode body: bf16, then f32 at each padded dim
DECODE_BODIES = {"bf16": pa.DECODE_TOKENS,
                 **{f"f32_d{dp}": t for dp, t in pa.DECODE_TOKENS_F32.items()}}


@pytest.mark.parametrize("body", sorted(DECODE_BODIES))
@pytest.mark.parametrize("page_tokens,n_slots", [(16, 64), (16, 256),
                                                  (12, 20), (1, 70)])
def test_decode_partitions_cover_every_token_once(page_tokens, n_slots, body):
    """Each decode body's grid comes from the table alone, and its blocks
    take every token of every sequence exactly once: lengths 0 and 1,
    around the partition and the table's reach, and past the reach
    (clamped), for page sizes that do and do not divide the partition."""
    tok = DECODE_BODIES[body]
    reach = n_slots * page_tokens
    parts = pa.decode_partitions(n_slots, page_tokens, tok)
    assert (parts - 1) * tok < reach <= parts * tok
    for length in sorted({-3, 0, 1, tok - 1, tok, tok + 1, 3 * tok + 5,
                          reach - 1, reach, reach + 1, 4 * reach}):
        seen = [t for p in range(parts) for t in
                _partition_tokens(p, length, n_slots, page_tokens, tok)]
        assert seen == list(range(max(0, min(length, reach)))), length
        active = [p for p in range(parts) if
                  _partition_tokens(p, length, n_slots, page_tokens, tok)]
        assert active == list(range(-(-max(0, min(length, reach)) // tok)))


@pytest.mark.parametrize("d", [16, 64, 100, 128, 200, 256])
def test_decode_tokens_by_dtype_and_head_dim(d):
    """bf16 decode takes DECODE_TOKENS-token partitions at every head
    dim; f32 takes its padded dim's entry, 64 or 128 tokens, a whole
    number of warps that divides the block's 256 threads."""
    assert pa.decode_tokens(torch.bfloat16, d) == pa.DECODE_TOKENS
    t = pa.decode_tokens(torch.float32, d)
    assert t == pa.DECODE_TOKENS_F32[pa.padded_dim(d)] and t in (64, 128)
    assert 256 % t == 0


# ======================================================================
# the copy engine (symm_copy) and the combine (reduce_combine)
# ======================================================================
from repro.kernels import reduce_combine as jrc  # noqa: E402
from repro.kernels import symm_copy as jsc  # noqa: E402
from repro_torch.kernels import reduce_combine as rc  # noqa: E402
from repro_torch.kernels import symm_copy as sc  # noqa: E402

COPY_DT = {"f32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16),
           "int8": (jnp.int8, torch.int8),
           "int32": (jnp.int32, torch.int32)}


def _pair(a, dt):
    """The same values as a JAX array and a torch tensor of ``dt``."""
    jdt, tdt = COPY_DT[dt]
    if dt in ("int8", "int32"):
        a = np.round(a * 40).astype(np.int8 if dt == "int8" else np.int32)
        return jnp.asarray(a), torch.from_numpy(a.copy())
    return (jnp.asarray(a, jnp.float32).astype(jdt),
            torch.from_numpy(a.astype(np.float32)).to(tdt))


def _np_of(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _jnp_of(a):
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                      else a)


# sizes: one element, a ragged row, past one tile, several column panels
# (the last only for the small blocks: interpret mode walks every tile)
COPY_CASES = [(v, dt, n) for v in sorted(sc.VARIANTS)
              for dt in sorted(COPY_DT) for n in (1, 127, 4099)] + \
             [(v, dt, 70001) for v in ("vmem_8x128", "vmem_32x128")
              for dt in ("f32", "int8")]


@pytest.mark.parametrize("variant,dt,n", COPY_CASES,
                         ids=[f"{v}-{d}-{n}" for v, d, n in COPY_CASES])
def test_copy_plain_matches_pallas_copy_blocked(variant, dt, n):
    a = np.random.RandomState(n).randn(n).astype(np.float32)
    shape = (n,) if n % 7 else (7, n // 7)
    ja, ta = _pair(a.reshape(shape), dt)
    want = jsc.copy_blocked(ja, variant, interpret=True)
    got = sc.copy_blocked(ta, variant)
    assert got.dtype == ta.dtype and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(_np_of(got), _jnp_of(want))
    assert got.data_ptr() != ta.data_ptr()


def test_copy_variant_dispatch_matches_reference():
    """block_shape and choose_variant give the reference's answers over a
    grid of sizes and dtypes (so dispatch and bench rows match)."""
    for dt in COPY_DT:
        jdt, tdt = COPY_DT[dt]
        for v in sc.VARIANTS:
            assert sc.block_shape(v, tdt) == jsc.block_shape(v, jdt), (v, dt)
        for nb in (0, 1, 1023, 1024, 2047, 2048, 4095, 4096, 4097,
                   32 << 10, (32 << 10) + 1, 256 << 10, (256 << 10) + 1,
                   1 << 20, (1 << 20) + 1, 8 << 20, (8 << 20) + 1, 1 << 30):
            assert sc.choose_variant(nb, tdt) == jsc.choose_variant(nb, jdt), \
                (nb, dt)
    assert sc.VARIANTS == jsc.VARIANTS
    assert sc.DEFAULT_VARIANT == jsc.DEFAULT_VARIANT
    assert ops.COPY_VARIANTS == ("stock", "auto") + tuple(jsc.VARIANTS)
    assert ops.COMBINE_VARIANTS == tuple(jrc.VARIANTS)


def _bulk_chunks(block, grid, n_bulk, tile_bytes):
    """(offset in the bulk, bytes) of each chunk block ``block`` of the
    copy kernel moves, in its order (the kernel's walk: tiles ``block``,
    ``block + grid``, ..., each in chunks of at most a ring stage)."""
    out = []
    for t0 in range(block * tile_bytes, n_bulk, grid * tile_bytes):
        t1 = min(t0 + tile_bytes, n_bulk)
        out += [(off, min(sc.STAGE_BYTES, t1 - off))
                for off in range(t0, t1, sc.STAGE_BYTES)]
    return out


COPY_PLAN_CASES = [(v, dt) for v in sorted(sc.VARIANTS)
                   for dt in ("f32", "int8")]


@pytest.mark.parametrize("variant,dt", COPY_PLAN_CASES,
                         ids=[f"{v}-{d}" for v, d in COPY_PLAN_CASES])
def test_copy_plan_moves_every_byte_once(variant, dt):
    """copy_plan and the blocks' chunks (the kernel's walk) move every
    byte exactly once: the head and tail under 16
    bytes, the bulk in 16-byte aligned chunks of at most a ring stage,
    one block per SM at most and none idle; pointers not co-aligned
    modulo 16, and payloads under 32 bytes, take the byte path."""
    tdt = COPY_DT[dt][1]
    r, c = sc.block_shape(variant, tdt)
    tile = r * c * torch.empty((), dtype=tdt).element_size()
    sms = 132
    for nbytes in (1, 31, 32, 4099, tile - 16, tile + 3, 3 * sc.STAGE_BYTES,
                   sms * tile + 17, 40 * (1 << 20) + 5):
        for src, dst in ((4096, 8192), (4096 + 16, 8192), (4096 + 5, 8192 + 5),
                         (4096 + 3, 8192)):
            path, head, n_bulk, grid = sc.copy_plan(src, dst, nbytes, tile,
                                                    sms)
            n_tiles = -(-nbytes // tile)
            if (src - dst) % 16 or nbytes < 32:
                assert (path, head, n_bulk) == ("bytes", 0, 0)
                assert grid == min(n_tiles, sc.MAX_BLOCKS)
                continue
            assert path == "bulk" and (src + head) % 16 == 0
            assert head < 16 and 0 <= nbytes - head - n_bulk < 16
            assert 1 <= grid <= min(sms, -(-n_bulk // tile))
            chunks = []
            for blk in range(grid):
                mine = _bulk_chunks(blk, grid, n_bulk, tile)
                assert mine, (nbytes, blk)
                chunks += mine
            end = 0                          # sorted, they tile the bulk
            for off, size in sorted(chunks):
                assert off == end and off % 16 == 0 and size % 16 == 0
                assert 0 < size <= sc.STAGE_BYTES
                end = off + size
            assert end == n_bulk, (nbytes, src)


def test_copy_front_door_dispatch():
    """"auto" sends payloads under one minimal tile to the bare copy and
    the rest to the blocked copy; "stock" never reaches the kernel
    wrapper."""
    calls = []
    orig = sc.copy_blocked
    try:
        sc.copy_blocked = lambda x, v: calls.append(v) or orig(x, v)
        small, big = torch.arange(1023.0), torch.arange(1024.0)
        assert torch.equal(sc.copy(small), small) and calls == []
        assert torch.equal(ops.symm_copy(big, "auto"), big)
        assert calls == ["vmem_8x128"]
        assert torch.equal(ops.symm_copy(big, "stock"), big)
        assert calls == ["vmem_8x128"]
    finally:
        sc.copy_blocked = orig
    with pytest.raises(ValueError, match="unknown copy variant"):
        sc.copy_blocked(big, "vmem_1x1")


COMBINE_CASES = [(op, dt) for op in ("sum", "prod", "max", "min")
                 for dt in ("f32", "bf16", "int32")]


@pytest.mark.parametrize("op,dt", COMBINE_CASES,
                         ids=[f"{o}-{d}" for o, d in COMBINE_CASES])
def test_combine_plain_matches_pallas_combine_blocked(op, dt):
    rng = np.random.RandomState(3)
    a, b = rng.randn(2, 33, 37).astype(np.float32)
    ja, ta = _pair(a, dt)
    jb, tb = _pair(b, dt)
    want = jrc.combine_blocked(ja, jb, op, interpret=True)
    got = ops.combine(ta, tb, op)
    assert got.dtype == ta.dtype
    np.testing.assert_array_equal(_np_of(got), _jnp_of(want))


def test_combine_propagates_nan_like_the_reference():
    a = np.array([1.0, np.nan, 2.0, -0.0, np.nan], np.float32)
    b = np.array([np.nan, 3.0, 1.0, 0.0, np.nan], np.float32)
    for op in ("max", "min", "sum"):
        want = jrc.combine_blocked(jnp.asarray(a), jnp.asarray(b), op,
                                   interpret=True)
        got = rc.combine_blocked(torch.from_numpy(a), torch.from_numpy(b), op)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_combine_raises_on_the_reference_mismatches():
    f = torch.zeros(4, 3)
    for bad in [(f, torch.zeros(3, 4), "sum"),
                (f, torch.zeros(4, 3, dtype=torch.bfloat16), "sum"),
                (f, f, "xor")]:
        with pytest.raises(ValueError):
            rc.combine_blocked(*bad)
        with pytest.raises(ValueError):
            jrc.combine_blocked(jnp.zeros(tuple(bad[0].shape)),
                                jnp.zeros(tuple(bad[1].shape),
                                          jnp.bfloat16
                                          if bad[1].dtype == torch.bfloat16
                                          else jnp.float32),
                                bad[2], interpret=True)


@pytest.mark.parametrize("sms", [132, 114, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32], ids=str)
def test_combine_grid_is_sized_to_the_card(dtype, sms):
    """BLOCKS_PER_SM blocks per SM (a multiple of the SM count) once the
    call has that many of the variant's tiles, one per tile below that,
    and one block for a call shorter than one vector."""
    isz = torch.empty((), dtype=dtype).element_size()
    cap = rc.BLOCKS_PER_SM * sms
    for variant, (r, c) in rc.VARIANTS.items():
        for vector in (True, False):
            vec = 16 // isz if vector else 1
            for n in (1, 3, 7, 1023, 4097, 1 << 20, 8 * (2 << 20)):
                grid = rc.combine_grid(n, isz, variant, vector, sms)
                tiles = -(-(n // vec) // max(r * c // vec, 1))
                assert grid == max(1, min(tiles, cap)), (variant, n, vector)
                if tiles >= cap:
                    assert grid % sms == 0
    # on an H100: the timing payload's 1024 tiles (8 x 8 MiB f32, the
    # default variant) fit the card at once, one block each; the
    # 16384 tiles of vmem_8x128 take the card's 8 x 132 blocks
    assert rc.combine_grid(8 * (2 << 20), 4, rc.DEFAULT_VARIANT, True,
                           132) == 1024
    assert rc.combine_grid(8 * (2 << 20), 4, "vmem_8x128", True, 132) \
        == rc.BLOCKS_PER_SM * 132 == 1056


@pytest.mark.parametrize("n,vector,variant", [
    (3, True, "vmem_8x128"), (4096 * 3 + 5, True, "vmem_8x128"),
    (65536 + 13, True, "vmem_64x256"), (70001, False, "vmem_64x256"),
    (1 << 18, True, "vmem_256x256")])
def test_combine_walk_covers_every_element_once(n, vector, variant):
    """The kernel's walk, modelled: tiles grid-stride over the blocks,
    each thread UNROLL vectors THREADS apart per step inside a tile, and
    block 0 the tail of fewer than one vector; every element once."""
    vec = 4 if vector else 1
    r, c = rc.VARIANTS[variant]
    tile_units = max(r * c // vec, 1)
    n_units = n // vec
    grid = rc.combine_grid(n, 4, variant, vector, 132)
    seen = np.zeros(n, np.int64)
    step = rc.THREADS * rc.UNROLL
    tids = np.arange(rc.THREADS)
    for blk in range(grid):
        for t in range(blk, -(-n_units // tile_units), grid):
            lo, hi = t * tile_units, min((t + 1) * tile_units, n_units)
            for i in range(lo, hi, step):
                for u in range(rc.UNROLL):
                    j = i + tids + u * rc.THREADS
                    for e in range(vec):
                        np.add.at(seen, j[j < hi] * vec + e, 1)
    tail = n_units * vec + tids
    np.add.at(seen, tail[tail < n], 1)
    assert (seen == 1).all()


def test_combine_library_step_checked(monkeypatch):
    """The wrapper holds the library's threads and unroll to its own."""
    lib = _FakeLib(combine_threads=rc.THREADS, combine_unroll=rc.UNROLL + 1)
    monkeypatch.setattr(rc.build, "load", lambda source: lib)
    monkeypatch.setattr(rc, "_FNS", {})
    with pytest.raises(RuntimeError, match="unroll"):
        rc._kernel(torch.float32)


def test_copy_and_combine_route_by_device(monkeypatch):
    """CPU tensors take the plain versions without building or counting;
    any other device goes to the kernel path, which raises for a
    non-CUDA tensor — never the plain version."""
    monkeypatch.setattr(sc.build, "load", lambda *a: pytest.fail(
        "CPU tensors must not build or load the CUDA library"))
    before = (dict(sc.LAUNCHES), dict(rc.LAUNCHES))
    x = torch.arange(5000.0)
    assert torch.equal(sc.copy_blocked(x, "vmem_8x128"), x)
    assert torch.equal(rc.combine_blocked(x, x, "sum"), 2 * x)
    assert (sc.LAUNCHES, rc.LAUNCHES) == before

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran for a non-CPU tensor")

    monkeypatch.setattr(sc, "copy_blocked_ref", no_plain)
    monkeypatch.setattr(rc, "combine_blocked_ref", no_plain)
    m = torch.empty(5000, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        sc.copy_blocked(m, "vmem_8x128")
    with pytest.raises(ValueError, match="CUDA tensors"):
        rc.combine_blocked(m, m, "sum")


# ======================================================================
# flash attention: the plain version against the Pallas kernel
# (interpret mode) and the blocked model attention against JAX's, grads
# included.  Tolerances are the reference's own: 2e-5 for the kernel
# (f32), 2e-2 in bf16, 5e-4 for blocked attention and its grads.
# ======================================================================
import jax  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.models import flash as jflash  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import flash as mflash  # noqa: E402


@pytest.mark.parametrize("case", REF_FLASH_CASES)
def test_flash_plain_matches_pallas_kernel_interpret(case):
    shape, opts = FLASH_CASES[case]
    q, k, v = _flash_case(*shape)
    want = jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          block_q=64, block_kv=64, **opts)
    out, lse = fa.flash_attention(_to_torch(q), _to_torch(k), _to_torch(v),
                                  **opts)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    # the log-sum-exp against the reference's blocked forward's
    b, h, t, d = q.shape
    hkv = k.shape[1]
    _, jlse = jflash._flash_chunk_fwd_impl(
        jnp.asarray(q.transpose(0, 2, 1, 3).reshape(b, t, hkv, h // hkv, d)),
        jnp.asarray(k.transpose(0, 2, 1, 3)),
        jnp.asarray(v.transpose(0, 2, 1, 3)), d ** -0.5, opts["causal"],
        opts.get("window"), k.shape[2], 32, False, 0)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(jlse).reshape(b, h, t),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_plain_dtypes_match_pallas(dt):
    q, k, v = _flash_case(9, 1, 4, 2, 64, 64, 32)
    want = jops.attention(*(jnp.asarray(a, JDT[dt]) for a in (q, k, v)),
                          block_q=32, block_kv=32)
    out = ops.attention(*(_to_torch(a, dt) for a in (q, k, v)))
    assert out.dtype == TDT[dt]
    tol = 2e-2 if dt == "bf16" else 2e-5
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_flash_wrapper_routes_by_device(monkeypatch):
    """CPU tensors take the plain version without building or counting;
    any other device goes to the kernel path, which raises for a
    non-CUDA tensor — never the plain version."""
    monkeypatch.setattr(fa.build, "load", lambda *a: pytest.fail(
        "CPU tensors must not build or load the CUDA library"))
    q, k, v = (_to_torch(a) for a in _flash_case(10, 1, 2, 1, 8, 8, 16))
    before = dict(fa.LAUNCHES)
    out, lse = fa.flash_attention(q, k, v)
    assert fa.LAUNCHES == before and lse.shape == (1, 2, 8)
    assert torch.equal(ops.attention(q, k, v), out)

    def no_plain(*a, **k_):
        raise AssertionError("the plain version ran for a non-CPU tensor")

    monkeypatch.setattr(fa, "flash_attention_ref", no_plain)
    m = torch.empty(1, 2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention(m, m[:, :1], m[:, :1])


# (b, t, h, hkv, d), options, block_q, block_kv
BLOCKED_CASES = {
    "causal_gqa": ((1, 96, 4, 2, 32), dict(causal=True), 32, 32),
    "mqa": ((2, 64, 4, 1, 32), dict(causal=True), 32, 16),
    "window_24": ((1, 80, 4, 2, 16), dict(causal=True, window=24), 16, 16),
    "noncausal": ((1, 64, 4, 4, 16), dict(causal=False), 32, 16),
    "ragged_t_70": ((1, 70, 4, 2, 16), dict(causal=True), 32, 32),
    "q_offset_kv_len": ((1, 24, 4, 2, 16),
                        dict(causal=True, q_offset=40, kv_len=56), 16, 16),
}


@pytest.mark.parametrize("case", sorted(BLOCKED_CASES))
def test_blocked_attention_and_grads_match_jax(case):
    """The port's blocked attention (plain forward on the CPU, blocked
    FlashAttention-2 backward) against JAX's ``blocked_attention`` and
    its custom VJP, on loss = sum(out * w)."""
    (b, t, h, hkv, d), opts, bq, bk = BLOCKED_CASES[case]
    s = t + opts.get("q_offset", 0)
    rng = np.random.RandomState(12)
    q = rng.randn(b, t, h, d).astype(np.float32)
    k = rng.randn(b, s, hkv, d).astype(np.float32)
    v = rng.randn(b, s, hkv, d).astype(np.float32)
    w = rng.randn(b, t, h, d).astype(np.float32)

    @jax.jit
    def jfwd_bwd(q_, k_, v_, w_):
        o, vjp = jax.vjp(lambda a, b_, c: jflash.blocked_attention(
            a, b_, c, block_q=bq, block_kv=bk, **opts), q_, k_, v_)
        return (o, *vjp(w_))

    jout, *jg = jfwd_bwd(*(jnp.asarray(a) for a in (q, k, v, w)))
    tq, tk, tv = (_to_torch(a).requires_grad_(True) for a in (q, k, v))
    out = mflash.blocked_attention(tq, tk, tv, block_q=bq, block_kv=bk,
                                   **opts)
    (out * _to_torch(w)).sum().backward()
    for got, want in zip((out, tq.grad, tk.grad, tv.grad), (jout, *jg)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=5e-4, atol=5e-4, err_msg=case)


def test_blocked_attention_impls_agree_on_cpu():
    """On CPU tensors ``impl="kernel"`` takes the plain forward, so both
    impls give the same bits; an unknown impl raises."""
    rng = np.random.RandomState(13)
    q, k, v = (_to_torch(rng.randn(1, 40, 4, 16)),
               _to_torch(rng.randn(1, 40, 2, 16)),
               _to_torch(rng.randn(1, 40, 2, 16)))
    a = mflash.blocked_attention(q, k, v, block_q=16, block_kv=16)
    r = mflash.blocked_attention(q, k, v, block_q=16, block_kv=16, impl="ref")
    assert torch.equal(a, r)
    with pytest.raises(ValueError, match="impl"):
        mflash.blocked_attention(q, k, v, impl="pallas")


# ======================================================================
# the redesigned kernels' Python side: tiles and limits per dtype, the
# 16-byte row check, and the prefill rows per block
# ======================================================================
def test_flash_tiles_per_dtype():
    """f32 runs 64 x 64 tiles on the CUDA cores, bf16 128 x 64 on the
    tensor cores: whole 16-row mma tiles and 16-deep k-steps."""
    assert fa.TILES == {torch.float32: (64, 64), torch.bfloat16: (128, 64)}
    assert fa.MAX_HEAD_DIM == 256 and fa.VECTOR_BYTES == 16
    assert all(n % 16 == 0 for n in fa.TILES[torch.bfloat16])


def test_paged_prefill_tile_fits_the_window_rows():
    rows, tokens = pa.PREFILL_TILE_BF16
    assert rows == pa.MAX_WINDOW_ROWS and rows % 16 == 0 and tokens % 16 == 0
    for g in range(1, pa.MAX_GROUP + 1):
        for w in (1, 3, 16, 64, 4096):
            assert 1 <= pa.choose_block(w, g) * g <= rows


class _FakeFn:
    """A stand-in for a ctypes function of the kernel library."""
    argtypes = None
    restype = None


class _FakeLib:
    def __init__(self, **values):
        self._values = values
        self._fns = {}

    def __getattr__(self, name):
        if name in self._values:
            v = self._values[name]
            return v if callable(v) else (lambda *a: v)
        return self._fns.setdefault(name, _FakeFn())


def _flash_lib(**over):
    vals = dict(flash_attention_max_head_dim=256,
                flash_attention_vector_bytes=16,
                flash_attention_block_q_f32=64,
                flash_attention_block_kv_f32=64,
                flash_attention_block_q_bf16=128,
                flash_attention_block_kv_bf16=64)
    return _FakeLib(**{**vals, **over})


@pytest.mark.parametrize("swap", [False, True], ids=["same", "swapped"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_library_tiles_checked_per_dtype(monkeypatch, dtype, swap):
    """The wrapper holds the library's tiles for the dtype it launches to
    its own, and raises where they differ (here: the other dtype's)."""
    sfx = {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]
    other = fa.TILES[torch.bfloat16 if dtype == torch.float32
                     else torch.float32]
    lib = _flash_lib(**({f"flash_attention_block_q_{sfx}": other[0]}
                        if swap else {}))
    monkeypatch.setattr(fa.build, "load", lambda source: lib)
    if swap:
        with pytest.raises(RuntimeError, match="limits"):
            fa._kernel(dtype)
    else:
        fn = fa._kernel(dtype)
        assert fn is getattr(lib, f"flash_attention_{sfx}")
        assert fn.argtypes == fa._ARGTYPES


@pytest.mark.parametrize("tile", [(64, 64), (64, 32)], ids=["same", "other"])
def test_paged_library_tile_checked(monkeypatch, tile):
    lib = _FakeLib(paged_attention_max_head_dim=256,
                   paged_attention_max_group=8,
                   paged_attention_max_window_rows=64,
                   paged_attention_vector_bytes=16,
                   paged_prefill_tile_rows_bf16=tile[0],
                   paged_prefill_tile_tokens_bf16=tile[1])
    monkeypatch.setattr(pa.build, "load", lambda source: lib)
    if tile == pa.PREFILL_TILE_BF16:
        pa._kernel("paged_prefill_attention", torch.bfloat16)
    else:
        with pytest.raises(RuntimeError, match="limits"):
            pa._kernel("paged_prefill_attention", torch.bfloat16)


@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_f32_prefill_tile_fits_a_block(d):
    """The f32 prefill body's dynamic shared memory (Q, then per token
    group a K and a V tile and the tile's P) fits one block beside its
    static row tables (64 ints + 64 offsets), and each group's K and V
    tiles can hold its partial output (64 score rows) for the merge."""
    dp = pa.padded_dim(d)
    assert dp >= d and dp in pa.PREFILL_TOKENS_F32
    tokens = pa.PREFILL_TOKENS_F32[dp]
    assert pa.prefill_f32_smem_bytes(d) + pa.MAX_WINDOW_ROWS * (4 + 8) \
        <= 232448
    assert 2 * tokens >= pa.MAX_WINDOW_ROWS and tokens % 16 == 0
    assert pa.PREFILL_GROUPS_F32 * 128 <= 1024


def test_f32_prefill_smem_pinned():
    """The sizes chip_smoke reports beside the library's own: 203,776 B
    at qwen3-8b's head dim, one block of 8 warps per SM."""
    assert {d: pa.prefill_f32_smem_bytes(d) for d in (16, 64, 128, 256)} \
        == {16: 121856, 64: 121856, 128: 203776, 256: 217088}
    assert 2 * pa.prefill_f32_smem_bytes(128) > 232448


def test_f32_decode_smem_pinned():
    """The f32 decode body's dynamic shared memory (a partition's K and V
    rows, then q of 8 heads) as chip_smoke reports it: 69,632 B at
    qwen3-8b's head dim, where three blocks share an SM beside their
    static offsets (2 x 64 int64) and the 1 KB each block reserves; every
    head dim fits one block of the H100's 227 KB."""
    assert {d: pa.decode_f32_smem_bytes(d) for d in (16, 64, 128, 256)} \
        == {16: 34816, 64: 34816, 128: 69632, 256: 139264}
    for d in (16, 64, 128, 256):
        assert pa.decode_f32_smem_bytes(d) + 2 * 64 * 8 <= 232448
    assert 3 * (pa.decode_f32_smem_bytes(128) + 2 * 64 * 8 + 1024) <= 233472


def _paged_lib(**over):
    vals = dict(paged_attention_max_head_dim=256,
                paged_attention_max_group=8,
                paged_attention_max_window_rows=64,
                paged_attention_vector_bytes=16,
                paged_prefill_tile_rows_bf16=64,
                paged_prefill_tile_tokens_bf16=64,
                paged_prefill_tile_tokens_f32=lambda dp:
                pa.PREFILL_TOKENS_F32[dp],
                paged_prefill_token_groups_f32=pa.PREFILL_GROUPS_F32,
                paged_prefill_smem_bytes_f32=pa.prefill_f32_smem_bytes,
                paged_decode_partition_tokens_f32=lambda dp:
                pa.DECODE_TOKENS_F32[dp],
                paged_decode_smem_bytes_f32=pa.decode_f32_smem_bytes)
    return _FakeLib(**{**vals, **over})


@pytest.mark.parametrize("over", [
    {}, {"paged_prefill_token_groups_f32": 1},
    {"paged_prefill_tile_tokens_f32": lambda dp: 32},
    {"paged_prefill_smem_bytes_f32": lambda dp: 1024}],
    ids=["same", "groups", "tokens", "smem"])
def test_paged_library_f32_tiles_checked(monkeypatch, over):
    """The wrapper holds the f32 prefill library's tiles, token groups and
    shared memory to its own at load, and raises where they differ."""
    lib = _paged_lib(**over)
    monkeypatch.setattr(pa.build, "load", lambda source: lib)
    if not over:
        fn = pa._kernel("paged_prefill_attention", torch.float32)
        assert fn is lib.paged_prefill_attention_f32
    else:
        with pytest.raises(RuntimeError, match="f32 prefill tiles"):
            pa._kernel("paged_prefill_attention", torch.float32)


@pytest.mark.parametrize("over", [
    {}, {"paged_decode_partition_tokens_f32": lambda dp: 128},
    {"paged_decode_smem_bytes_f32": lambda dp: 4096}],
    ids=["same", "tokens", "smem"])
def test_paged_library_f32_decode_checked(monkeypatch, over):
    """The wrapper holds the f32 decode library's partitions and shared
    memory to its own at load, and raises where they differ."""
    lib = _paged_lib(**over)
    monkeypatch.setattr(pa.build, "load", lambda source: lib)
    if not over:
        fn = pa._kernel("paged_decode_attention", torch.float32)
        assert fn is lib.paged_decode_attention_f32
        assert fn.argtypes == pa._ARGTYPES["paged_decode_attention"]
    else:
        with pytest.raises(RuntimeError, match="f32 decode partitions"):
            pa._kernel("paged_decode_attention", torch.float32)


def test_launches_counted_by_dtype():
    """Every wrapper's launches are also kept by the body's dtype, and
    reset_launches clears both counts."""
    assert set(pa.LAUNCHES_BY_DTYPE) == {(n, t) for n in pa.LAUNCHES
                                         for t in ("f32", "bf16")}
    saved = dict(pa.LAUNCHES), dict(pa.LAUNCHES_BY_DTYPE)
    try:
        pa._count("paged_prefill_attention", torch.float32)
        pa._count("paged_decode_attention", torch.bfloat16)
        assert pa.LAUNCHES_BY_DTYPE[("paged_prefill_attention", "f32")] \
            == saved[1][("paged_prefill_attention", "f32")] + 1
        assert pa.LAUNCHES["paged_decode_attention"] \
            == saved[0]["paged_decode_attention"] + 1
        pa.reset_launches()
        assert not any(pa.LAUNCHES.values())
        assert not any(pa.LAUNCHES_BY_DTYPE.values())
    finally:
        pa.LAUNCHES.update(saved[0])
        pa.LAUNCHES_BY_DTYPE.update(saved[1])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("model", sorted(MODEL_HEADS))
def test_models_layouts_fit_the_16_byte_copies(model, dt):
    """Every layout ``models/flash.py`` passes the flash kernel is one
    its 16-byte copies take (the GPU test runs the same views)."""
    q, k, v = model_layout(MODEL_HEADS[model], dt)
    assert not q.is_contiguous()
    assert [fa.misalignment(x) for x in (q, k, v)] == [None, None, None]


def _misaligned(case, dtype):
    if case == "row_stride":              # rows 72 / 36 bytes apart
        return torch.zeros(2, 3, 8, 18, dtype=dtype)[..., :16], "dim 2"
    if case == "head_stride":             # heads and rows 18 elements apart
        x = torch.zeros(2, 8, 3, 18, dtype=dtype)[..., :16].transpose(1, 2)
        return x, "dim 1"
    if case == "start":
        flat = torch.zeros(1 + 2 * 3 * 8 * 16, dtype=dtype)
        return flat[1:].view(2, 3, 8, 16), "starts"
    # odd strides on dims of size 1 are never stepped: fine
    x = torch.zeros(400, dtype=dtype).as_strided((1, 1, 8, 16), (3, 5, 16, 1))
    return x, None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", ["row_stride", "head_stride", "start",
                                  "size_one_dims"])
def test_misalignment_names_what_the_copies_cannot_take(case, dtype):
    x, want = _misaligned(case, dtype)
    why = fa.misalignment(x)
    if want is None:
        assert why is None
    else:
        assert why is not None and want in why


@pytest.mark.parametrize("case", ["pool_view", "odd_start", "d12"])
def test_bf16_prefill_checks_its_rows(case):
    """The bf16 prefill body's q and page rows must be 16-byte aligned:
    the engine's per-layer pool view is; an odd start or a head dim of
    12 (24-byte rows) raises."""
    d = 12 if case == "d12" else 128
    pool = torch.zeros(5, 2, 2, 16, 2, d, dtype=torch.bfloat16)
    kp, vp = pool[:, 0, 1], pool[:, 1, 1]
    q = torch.zeros(2, 4, 4, d, dtype=torch.bfloat16)
    if case == "odd_start":
        kp = torch.zeros(kp.numel() + 1, dtype=torch.bfloat16)[1:].view(
            kp.shape)
    if case == "pool_view":
        pa.check_vectors("bf16 prefill", q=q, k_pages=kp, v_pages=vp)
    else:
        with pytest.raises(ValueError, match="16-byte"):
            pa.check_vectors("bf16 prefill", q=q, k_pages=kp, v_pages=vp)
