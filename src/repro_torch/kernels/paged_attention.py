"""Paged attention through a block table: CUDA kernels for Hopper, their
plain PyTorch versions, and the wrappers that pick between them.

The serving engine keeps the KV cache as fixed-size pages of the
symmetric heap's pool; a sequence's cache is a *block table* of page
ids.  Two kernels (``csrc/paged_attention.cu``, CUDA C++ for
``sm_90a``) compute attention directly against that layout:

  * ``paged_decode_attention`` replaces the Pallas kernel
    ``repro.kernels.paged_attention.paged_decode_attention`` (body
    ``_paged_kernel``): one decode step, one launch, grid (KV head,
    sequence, token partition) from the block table's reach, the
    partials merged in the same launch.
  * ``paged_prefill_attention`` replaces
    ``repro.kernels.paged_attention.paged_prefill_attention`` (body
    ``_prefill_kernel``): a whole chunked-prefill window, grid
    (sequence, q block, KV head), each row with its own causal bound.

What bounds them on an H100 is bytes: the K/V pages each sequence has
filled, read once per KV head (decode at 8 sequences of 512 tokens
reads ~16.8 MB per layer in bf16, ~5 us at 3.35 TB/s), against 4 flops
per K/V element.  The design: the walk stops at the last valid token
(the TPU grid visits all ``n_slots`` table slots — 256 at
``max_seq=4096``, P=16); the per-layer K/V is read IN PLACE as a
strided view of the whole ``(n_pages, 2, L, P, H_kv, D)`` pool (the
page stride is a kernel argument; a ``.contiguous()`` here would copy
the pool twice per layer per tick).

Decode has one body per dtype, a fixed dispatch, both of one
structure: fixed partitions of ``decode_tokens(dtype, D)`` tokens per
(sequence, KV head) — ``DECODE_TOKENS`` in bf16 (the port's default),
``DECODE_TOKENS_F32`` by padded head dim in f32 (the reference's
serving dtype) — each block staging its partition's K/V rows with
16-byte ``cp.async`` copies (so q and page rows must start and step
16-byte aligned, ``check_vectors``); bf16 runs both products on the
tensor cores, f32 on the CUDA cores.  The grid is H_kv x B x
``decode_partitions(n_slots, P, tokens)``, fixed by the table, so the
host never reads ``lengths`` (no sync in the decode step); every block
of a (sequence, KV head) writes its partial and takes a ticket, and the
block that draws the last ticket merges the partials in partition order
(the same bits on every call; no block waits for another).  Both take
their scratch (partials, tickets) from one cache per device and stream
(``_scratch``), not from a fresh allocation per call: the launches of a
stream run one after another, and each leaves the tickets at zero.

The prefill window has one body per dtype, a fixed dispatch (no
fallback), both a tile walk over the context gathered through the block
table with 16-byte ``cp.async`` copies, up to 64 score rows (window
rows x the query heads of one KV head) per block; so q and page rows
must start and step 16-byte aligned, which the wrapper checks
(``check_vectors``).  bf16 (the port's default) runs both products on
the tensor cores (``mma.sync``) over tiles of 64 tokens; f32 (the
reference's serving dtype) on the CUDA cores as per-thread register
tiles, the context split over ``PREFILL_GROUPS_F32`` token groups of
128 threads, each walking every other tile of ``PREFILL_TOKENS_F32``
tokens with its own softmax state, merged at the end.

Semantics are the reference's to the constant: ``NEG_INF = -1e30``,
p re-masked after the exp, denominator ``max(l, 1e-30)``, ``sm_scale =
1/sqrt(D)``, f32 accumulation; a decode row of length 0 and a window
row ``j >= n_tok`` are exact zeros.

The wrappers take the plain version for CPU tensors — only there.  For
a CUDA tensor they launch the kernel or raise; nothing falls back.
``LAUNCHES`` counts kernel launches per wrapper (plain integers; one
per call), so a run can show
that its main path went through the kernels; ``LAUNCHES_BY_DTYPE``
splits the same counts by the body's dtype.
"""
from __future__ import annotations

import ctypes
import math
import torch

from . import build
from .flash_attention import VECTOR_BYTES, check_vectors

NEG_INF = -1e30
SOURCE = "paged_attention.cu"
# q-block rows of the prefill window kernel, see choose_block
BLOCK_Q = 16
# limits of the kernels (checked against the library's own at launch)
MAX_HEAD_DIM = 256
MAX_GROUP = 8
MAX_WINDOW_ROWS = 64
# the bf16 prefill body's tile: score rows per block, context tokens
PREFILL_TILE_BF16 = (64, 64)
# the f32 prefill body: context tokens per tile by padded head dim, token
# groups of 128 threads per block, floats of padding per shared row
PREFILL_TOKENS_F32 = {64: 64, 128: 64, 256: 32}
PREFILL_GROUPS_F32 = 2
_F32_PAD = 4
# decode: tokens per partition, in bf16 and in f32 by padded head dim
DECODE_TOKENS = 128
DECODE_TOKENS_F32 = {64: 64, 128: 64, 256: 64}

LAUNCHES = {"paged_decode_attention": 0, "paged_prefill_attention": 0}
LAUNCHES_BY_DTYPE = {(name, tag): 0 for name in LAUNCHES
                     for tag in ("f32", "bf16")}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_ARGTYPES = {
    "paged_decode_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                               _I, _I, _I, _I, _L, _L, _F, _P],
    "paged_prefill_attention": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _I, _I, _L, _L, _F, _I, _P],
}
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def reset_launches() -> None:
    for counts in (LAUNCHES, LAUNCHES_BY_DTYPE):
        for k in counts:
            counts[k] = 0


def _count(name: str, dtype: torch.dtype) -> None:
    LAUNCHES[name] += 1
    LAUNCHES_BY_DTYPE[(name, _SUFFIX[dtype])] += 1


def padded_dim(d: int) -> int:
    """The head dim a kernel body is built for: 64, 128 or 256."""
    return 64 if d <= 64 else 128 if d <= 128 else 256


def prefill_f32_smem_bytes(d: int) -> int:
    """Dynamic shared memory of an f32 prefill block at head dim ``d``:
    Q (64 score rows), then per token group a K and a V tile and the
    tile's probabilities (column-major, 64 + pad rows), rows padded by 4
    floats."""
    dp = padded_dim(d)
    t = PREFILL_TOKENS_F32[dp]
    ld, ldp = dp + _F32_PAD, MAX_WINDOW_ROWS + _F32_PAD
    return 4 * (MAX_WINDOW_ROWS * ld + PREFILL_GROUPS_F32 * t * (2 * ld + ldp))


def decode_f32_smem_bytes(d: int) -> int:
    """Dynamic shared memory of an f32 decode block at head dim ``d``: a
    partition's K and V rows, then q of 8 heads, at the padded dim."""
    dp = padded_dim(d)
    return 4 * (2 * DECODE_TOKENS_F32[dp] * dp + MAX_GROUP * dp)


def choose_block(window: int, group: int = 1) -> int:
    """Prefill-window q-block rows on the H100.

    A block takes up to 64 score rows (window rows x the GQA group): in
    bf16 four 16-row tensor-core tiles, one per warp; in f32 8 row
    groups of 8 rows in each of its token groups.  At qwen3-8b's group
    of 4 that is 16 window rows, and at the main path's window (B=8,
    C=64, H_kv=8) a grid of 8 x 4 x 8 = 256 blocks (80 KB of shared
    memory each in bf16, two per SM of the 132; 199 KB in f32, one).
    Shorter windows take one block of exactly their rows."""
    return max(1, min(BLOCK_Q, int(window), MAX_WINDOW_ROWS // int(group)))


def decode_tokens(dtype: torch.dtype, d: int) -> int:
    """Tokens per partition of the decode body for ``dtype`` at head dim
    ``d``."""
    return DECODE_TOKENS if dtype == torch.bfloat16 else \
        DECODE_TOKENS_F32[padded_dim(d)]


def decode_partitions(n_slots: int, page_tokens: int, tokens: int) -> int:
    """Partitions of the decode grid per (sequence, KV head): the table's
    reach in ``tokens``-token pieces, whatever the lengths (the grid is
    fixed without reading them)."""
    return -(-n_slots * page_tokens // tokens)


_SCRATCH: dict = {}


def _scratch(device: torch.device, stream: int, name: str, numel: int,
             dtype=torch.float32) -> torch.Tensor:
    """A kernel's scratch buffer, cached per (device, stream, name) and
    grown when a call needs more.  The decode tickets start at zero, and
    each launch leaves them zero."""
    key = (device.index, stream, name)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < numel:
        buf = torch.zeros(max(numel, 1), dtype=dtype, device=device)
        _SCRATCH[key] = buf
    return buf


def _partials(device, stream: int, rows: int, d: int) -> tuple:
    """Pointers to the cached (m, l, acc) partials of ``rows`` rows."""
    return tuple(_scratch(device, stream, name, n).data_ptr()
                 for name, n in (("m", rows), ("l", rows), ("acc", rows * d)))


# ======================================================================
# plain versions: gather the pages, dense masked softmax in f32
# ======================================================================
def paged_decode_attention_ref(q, k_pages, v_pages, block_tables, lengths):
    """q (B, H, D); k/v_pages (n_pages, P, H_kv, D); block_tables
    (B, n_slots) int; lengths (B,) int -> (B, H, D) in q's dtype."""
    b, h, d = q.shape
    _, page_tokens, hkv, _ = k_pages.shape
    group = h // hkv
    s_max = block_tables.shape[1] * page_tokens
    sm_scale = 1.0 / math.sqrt(d)
    bt = block_tables.long()
    kc = k_pages[bt].reshape(b, s_max, hkv, d).float()
    vc = v_pages[bt].reshape(b, s_max, hkv, d).float()
    qg = q.reshape(b, hkv, group, d).float()
    sc = torch.einsum("bhgd,bshd->bhgs", qg, kc) * sm_scale
    cols = torch.arange(s_max, device=q.device)
    valid = (cols[None, :] < lengths.long()[:, None])[:, None, None, :]
    sc = torch.where(valid, sc, torch.full_like(sc, NEG_INF))
    m = sc.amax(-1, keepdim=True)
    p = torch.exp(sc - m)
    p = torch.where(valid, p, torch.zeros_like(p))
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bhgs,bshd->bhgd", p, vc)
    out = acc / l.clamp_min(1e-30)
    return out.reshape(b, h, d).to(q.dtype)


def paged_prefill_attention_ref(q, k_pages, v_pages, block_tables, start,
                                n_tok):
    """q (B, C, H, D): row j of sequence b sits at position
    ``start[b] + j`` and attends to the first ``start[b] + j + 1``
    paged tokens; rows ``j >= n_tok[b]`` are exactly zero."""
    b, c, h, d = q.shape
    _, page_tokens, hkv, _ = k_pages.shape
    group = h // hkv
    s_max = block_tables.shape[1] * page_tokens
    sm_scale = 1.0 / math.sqrt(d)
    bt = block_tables.long()
    kc = k_pages[bt].reshape(b, s_max, hkv, d).float()
    vc = v_pages[bt].reshape(b, s_max, hkv, d).float()
    qg = q.reshape(b, c, hkv, group, d).float()
    sc = torch.einsum("bchgd,bshd->bchgs", qg, kc) * sm_scale
    j = torch.arange(c, device=q.device)[None]
    pos = start.long()[:, None] + j                                # (B, C)
    lens = torch.where(j < n_tok.long()[:, None], pos + 1,
                       torch.zeros_like(pos))
    cols = torch.arange(s_max, device=q.device)
    valid = (cols[None, None] < lens[:, :, None])[:, :, None, None, :]
    sc = torch.where(valid, sc, torch.full_like(sc, NEG_INF))
    m = sc.amax(-1, keepdim=True)
    p = torch.exp(sc - m)
    p = torch.where(valid, p, torch.zeros_like(p))
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bchgs,bshd->bchgd", p, vc)
    out = acc / l.clamp_min(1e-30)
    return out.reshape(b, c, h, d).to(q.dtype)


# ======================================================================
# wrappers
# ======================================================================
def _kernel(name: str, dtype: torch.dtype):
    lib = build.load(SOURCE)
    full = f"{name}_{_SUFFIX[dtype]}"
    fn = getattr(lib, full)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES.get(full, _ARGTYPES.get(name))
        fn.restype = ctypes.c_int
        limits = (lib.paged_attention_max_head_dim(),
                  lib.paged_attention_max_group(),
                  lib.paged_attention_max_window_rows(),
                  lib.paged_attention_vector_bytes(),
                  lib.paged_prefill_tile_rows_bf16(),
                  lib.paged_prefill_tile_tokens_bf16())
        if limits != (MAX_HEAD_DIM, MAX_GROUP, MAX_WINDOW_ROWS, VECTOR_BYTES,
                      *PREFILL_TILE_BF16):
            raise RuntimeError(f"kernel library limits {limits} differ from "
                               f"the wrapper's")
        if full == "paged_decode_attention_bf16" and \
                lib.paged_decode_partition_tokens_bf16() != DECODE_TOKENS:
            raise RuntimeError("kernel library's decode partition differs "
                               "from the wrapper's")
        if full == "paged_decode_attention_f32":
            got = ({dp: lib.paged_decode_partition_tokens_f32(dp)
                    for dp in DECODE_TOKENS_F32},
                   {dp: lib.paged_decode_smem_bytes_f32(dp)
                    for dp in DECODE_TOKENS_F32})
            want = (DECODE_TOKENS_F32,
                    {dp: decode_f32_smem_bytes(dp) for dp in DECODE_TOKENS_F32})
            if got != want:
                raise RuntimeError(f"kernel library's f32 decode partitions "
                                   f"{got} differ from the wrapper's {want}")
        if full == "paged_prefill_attention_f32":
            got = ({dp: lib.paged_prefill_tile_tokens_f32(dp)
                    for dp in PREFILL_TOKENS_F32},
                   lib.paged_prefill_token_groups_f32(),
                   {dp: lib.paged_prefill_smem_bytes_f32(dp)
                    for dp in PREFILL_TOKENS_F32})
            want = (PREFILL_TOKENS_F32, PREFILL_GROUPS_F32,
                    {dp: prefill_f32_smem_bytes(dp)
                     for dp in PREFILL_TOKENS_F32})
            if got != want:
                raise RuntimeError(f"kernel library's f32 prefill tiles "
                                   f"{got} differ from the wrapper's {want}")
    return fn


def _check(q, k_pages, v_pages, block_tables, ints, q_dims: int):
    """Validate what the CUDA kernels take; raise on anything else."""
    if q.device.type != "cuda":
        raise ValueError(f"the paged-attention kernels run on CUDA tensors, "
                         f"got {q.device}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables),
                    *((f"int arg {i}", t) for i, t in enumerate(ints))):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    if q.dtype not in _SUFFIX:
        raise TypeError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"q {q.dtype}, k_pages {k_pages.dtype}, v_pages "
                        f"{v_pages.dtype}: the kernel takes one dtype")
    if q.dim() != q_dims or not q.is_contiguous():
        raise ValueError(f"q must be a contiguous {q_dims}-d tensor, got "
                         f"shape {tuple(q.shape)} strides {q.stride()}")
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"k/v pages must be (n_pages, P, H_kv, D), got "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    _, page_tokens, hkv, d = k_pages.shape
    inner = (hkv * d, d, 1)
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.stride()[1:] != inner:
            raise ValueError(
                f"{name}: each page must be contiguous (P, H_kv, D) with "
                f"strides {inner}, got {t.stride()[1:]} (pages may sit any "
                f"stride apart)")
    h = q.shape[-2]
    if q.shape[-1] != d or h % hkv:
        raise ValueError(f"q heads/dim {tuple(q.shape[-2:])} do not fit "
                         f"pages with H_kv={hkv}, D={d}")
    if d > MAX_HEAD_DIM or h // hkv > MAX_GROUP:
        raise ValueError(f"kernel takes head_dim <= {MAX_HEAD_DIM} and GQA "
                         f"group <= {MAX_GROUP}, got D={d}, group={h // hkv}")
    b = q.shape[0]
    if (block_tables.dtype != torch.int32 or block_tables.dim() != 2
            or block_tables.shape[0] != b or not block_tables.is_contiguous()):
        raise ValueError("block_tables must be a contiguous (B, n_slots) "
                         "int32 tensor")
    for t in ints:
        if t.dtype != torch.int32 or t.shape != (b,) or not t.is_contiguous():
            raise ValueError("lengths/start/n_tok must be contiguous (B,) "
                             "int32 tensors")
    return b, h, hkv, d, page_tokens, block_tables.shape[1]


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """One decode step of attention through a block table.

    q (B, H, D); k/v_pages (n_pages, P, H_kv, D), each page contiguous,
    pages any stride apart (a per-layer view of the pool); block_tables
    (B, n_slots) int32; lengths (B,) int32 (0 = inactive -> zero row).
    Token t of sequence b lives in page ``block_tables[b, t // P]``.
    bf16 launches the partitioned tensor-core body, f32 the partitioned
    CUDA-core one; both stage q and page rows in 16-byte copies (rows not
    16-byte aligned: ``ValueError``)."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pages, v_pages, block_tables,
                                          lengths)
    b, h, hkv, d, page_tokens, n_slots = _check(
        q, k_pages, v_pages, block_tables, (lengths,), q_dims=3)
    check_vectors(f"{_SUFFIX[q.dtype]} decode", q=q, k_pages=k_pages,
                  v_pages=v_pages)
    sm_scale = 1.0 / math.sqrt(d)
    fn = _kernel("paged_decode_attention", q.dtype)
    out = torch.empty_like(q)
    # partial (m, l, acc) per (sequence, KV head, partition, head)
    rows = b * h * decode_partitions(n_slots, page_tokens,
                                     decode_tokens(q.dtype, d))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        tickets = _scratch(q.device, stream, "tickets", b * hkv, torch.int32)
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 block_tables.data_ptr(), lengths.data_ptr(),
                 *_partials(q.device, stream, rows, d), tickets.data_ptr(),
                 out.data_ptr(), b, h, hkv, d, page_tokens, n_slots,
                 k_pages.stride(0), v_pages.stride(0), sm_scale, stream)
    _raise_on(err, "paged_decode_attention")
    _count("paged_decode_attention", q.dtype)
    return out


def paged_prefill_attention(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor,
                            block_tables: torch.Tensor, start: torch.Tensor,
                            n_tok: torch.Tensor) -> torch.Tensor:
    """Chunk-window attention through the block table.

    q (B, C, H, D): row j of sequence b sits at position ``start[b] + j``
    and attends to the first ``start[b] + j + 1`` paged tokens (the
    window's K/V already written); rows ``j >= n_tok[b]`` are exactly
    zero.  Pages as in :func:`paged_decode_attention`; the q-block rows
    come from :func:`choose_block`.  bf16 launches the tensor-core body,
    f32 the CUDA-core one; both stage q and page rows in 16-byte copies
    (rows not 16-byte aligned: ``ValueError``)."""
    if q.device.type == "cpu":
        return paged_prefill_attention_ref(q, k_pages, v_pages, block_tables,
                                           start, n_tok)
    b, h, hkv, d, page_tokens, n_slots = _check(
        q, k_pages, v_pages, block_tables, (start, n_tok), q_dims=4)
    check_vectors(f"{_SUFFIX[q.dtype]} prefill", q=q, k_pages=k_pages,
                  v_pages=v_pages)
    c = q.shape[1]
    sm_scale = 1.0 / math.sqrt(d)
    block_q = choose_block(c, h // hkv)
    fn = _kernel("paged_prefill_attention", q.dtype)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 block_tables.data_ptr(), start.data_ptr(), n_tok.data_ptr(),
                 out.data_ptr(), b, c, h, hkv, d, page_tokens, n_slots,
                 k_pages.stride(0), v_pages.stride(0), sm_scale, block_q,
                 stream)
    _raise_on(err, "paged_prefill_attention")
    _count("paged_prefill_attention", q.dtype)
    return out
