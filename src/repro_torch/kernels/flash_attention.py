"""Blocked (flash) attention forward: a CUDA kernel for Hopper, its plain
PyTorch version, and the wrapper that picks between them.

``flash_attention`` replaces the Pallas kernel
``repro.kernels.flash_attention.flash_attention`` (body ``_flash_kernel``):
causal and/or sliding-window softmax attention with GQA (query head
``h`` reads KV head ``h // (H / H_kv)``, no K/V replication), f32
accumulation, ``NEG_INF = -1e30`` for masked scores, ``sm_scale =
1/sqrt(D)`` by default and the output divided by ``max(l, 1e-30)``.
Besides the output it returns the rows' log-sum-exp, which the training
backward (``repro_torch.models.flash``) reads: ``m + log(max(l,
1e-30))``, or ``BIG = 3e37`` where ``l == 0``.  ``q_offset`` places query
row ``i`` at position ``q_offset + i`` (0 is the Pallas kernel) and
``kv_len`` masks the columns at and past it.  ``pe_rows`` and
``pe_stride`` give each batch row its own offset, ``q_offset + (b //
pe_rows) * pe_stride``: the stacked TP layout's ctx attention folds
every PE's ``pe_rows`` rows into the batch, PE ``r``'s queries sitting
at ``r * pe_stride`` of the gathered sequence (``query_positions``).  At
``pe_stride = 0`` every row takes ``q_offset``, as before.

The kernel (``csrc/flash_attention.cu``, CUDA C++ for ``sm_90a``) is
bound by operations: at the training shape (q (1, 8, 4096, 256), k/v
(1, 1, 4096, 256), causal, f32) it does 6.9e10 flops on 40 MB.  It has
one body per dtype, each with its own tiles (``TILES``, checked against
the library's at load):

  * f32, the training path, on the CUDA cores (TF32 would change the
    numbers): q tiles of 64 rows, K and V tiles of 64 rows alternating
    through a two-buffer ring of 16-byte ``cp.async`` copies, an 8 x 4
    score and an 8 x 16 output register tile per thread;
  * bf16 on the tensor cores (``mma.sync`` m16n8k16, f32 accumulate): q
    tiles of 128 rows over 8 warps, a two-stage K/V ring of 64-row
    tiles, the online softmax on the accumulator fragments and P kept in
    registers as the A operand of P V.

Both skip whole tiles outside the causal or window range and mask the
ragged edges in the kernel (no pad copies); every tensor comes with its
strides, so the model's ``(b, t, h, d)`` layout is read and written in
place — as long as q, k and v start 16-byte aligned and their batch,
head and row strides are multiples of 16 bytes, which the wrapper checks
(``misalignment``) and raises on otherwise.  See the source for the
rest.

The plain version (``flash_attention_ref``) is the dense masked softmax
of ``repro.kernels.ref.attention_ref`` in f32, plus the log-sum-exp.
The wrapper takes it for CPU tensors — only there.  For a CUDA tensor it
launches the kernel or raises; nothing falls back.  ``LAUNCHES`` counts
kernel launches (a plain integer), so a run can show that its main path
went through the kernel.  For a **meta** tensor (the dry run,
``launch.dryrun``) it checks the call as for the card, returns outputs
of the kernel's shapes and dtypes, and adds the kernel's work to
``META``: its operations (``flash_flops``: 4 D a (row, column, head)
triple the masks leave, the count the bound of ``chip_smoke.py`` uses)
and its bytes (q, k, v read once, out and lse written once).  Any other
device raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import build

NEG_INF = -1e30
BIG = 3.0e37            # lse of a row with no valid column
SOURCE = "flash_attention.cu"
MAX_HEAD_DIM = 256
VECTOR_BYTES = 16               # the kernels' global -> shared copies
# (q rows, KV rows) of each body's tiles (checked at load)
TILES = {torch.float32: (64, 64), torch.bfloat16: (128, 64)}

LAUNCHES = {"flash_attention": 0}
# the meta route's tally: calls, operations, bytes
META = {"calls": 0, "flops": 0, "bytes": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
             ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
             _I, _I, _I, _I, _I, _I, _P]
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def reset_meta() -> None:
    for k in META:
        META[k] = 0


def visible_pairs(t: int, offset: int, causal: bool,
                  window: Optional[int], kv_len: int) -> int:
    """(row, column) pairs the masks leave for ``t`` query rows from
    position ``offset`` over ``kv_len`` valid keys: what one head of one
    batch row computes."""
    p = offset + torch.arange(t, dtype=torch.int64)
    hi = torch.clamp(p, max=kv_len - 1) if causal else \
        torch.full_like(p, kv_len - 1)
    lo = torch.clamp(p - window + 1, min=0) if window is not None \
        else torch.zeros_like(p)
    return int(torch.clamp(hi - lo + 1, min=0).sum())


def flash_flops(b: int, h: int, t: int, s: int, d: int, *,
                causal: bool = True, window: Optional[int] = None,
                q_offset: int = 0, kv_len: Optional[int] = None,
                pe_rows: int = 1, pe_stride: int = 0) -> int:
    """The kernel's operations for one call: QK^T and PV, 2 D each, over
    every visible (row, column, head) triple."""
    kv_len = s if kv_len is None else min(kv_len, s)
    offs = [q_offset + (i // pe_rows) * pe_stride for i in range(b)]
    pairs = sum(offs.count(o) * visible_pairs(t, o, causal, window, kv_len)
                for o in set(offs))
    return 4 * d * h * pairs


def attention_mask(rows: torch.Tensor, cols: torch.Tensor, causal: bool,
                   window: Optional[int], kv_len: int) -> torch.Tensor:
    """(..., rows, cols) bool for row positions (..., rows): the column
    exists (``< kv_len``), and is not after the row (causal) nor
    ``window`` or more before it."""
    m = cols[None, :] < kv_len
    if causal:
        m = m & (cols[None, :] <= rows[..., :, None])
    if window is not None:
        m = m & (cols[None, :] > rows[..., :, None] - window)
    return m


def query_positions(q_offset: int, t: int, device, b: int = 1,
                    pe_rows: int = 1, pe_stride: int = 0) -> torch.Tensor:
    """The positions of ``t`` query rows: (t,) ``q_offset + i`` at
    ``pe_stride = 0``; else (b, t), batch row ``b`` at ``q_offset + (b //
    pe_rows) * pe_stride + i``."""
    rows = q_offset + torch.arange(t, device=device)
    if not pe_stride:
        return rows
    pe = torch.arange(b, device=device) // pe_rows
    return rows[None, :] + (pe * pe_stride)[:, None]


def check_pe(b: int, pe_rows: int, pe_stride: int) -> None:
    """Raise unless ``pe_rows`` PE rows tile the batch of ``b``."""
    if pe_rows < 1 or b % pe_rows or pe_stride < 0:
        raise ValueError(f"pe_rows {pe_rows} must be >= 1 and divide the "
                         f"batch {b}, pe_stride {pe_stride} >= 0")


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        sm_scale: Optional[float] = None, q_offset: int = 0,
                        kv_len: Optional[int] = None, pe_rows: int = 1,
                        pe_stride: int = 0):
    """Dense masked softmax in f32: q (B, H, T, D), k/v (B, H_kv, S, D)
    -> (out (B, H, T, D) in q's dtype, lse (B, H, T) f32)."""
    b, h, t, d = q.shape
    check_pe(b, pe_rows, pe_stride)
    hkv, s = k.shape[1], k.shape[2]
    group = h // hkv
    sm_scale = 1.0 / math.sqrt(d) if sm_scale is None else sm_scale
    kv_len = s if kv_len is None else kv_len
    qg = q.float().reshape(b, hkv, group, t, d)
    sc = torch.einsum("bhgtd,bhsd->bhgts", qg, k.float()) * sm_scale
    mask = attention_mask(query_positions(q_offset, t, q.device, b, pe_rows,
                                          pe_stride),
                          torch.arange(s, device=q.device), causal, window,
                          kv_len)
    if pe_stride:
        mask = mask[:, None, None]                 # (B, 1, 1, T, S)
    sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
    m = sc.amax(-1)
    p = torch.exp(sc - m[..., None])
    l = p.sum(-1)
    out = torch.einsum("bhgts,bhsd->bhgtd", p, v.float()) \
        / l.clamp_min(1e-30)[..., None]
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)),
                      torch.full_like(l, BIG))
    return (out.reshape(b, h, t, d).to(q.dtype), lse.reshape(b, h, t))


def _kernel(dtype: torch.dtype):
    lib = build.load(SOURCE)
    sfx = _SUFFIX[dtype]
    fn = getattr(lib, f"flash_attention_{sfx}")
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        limits = (lib.flash_attention_max_head_dim(),
                  lib.flash_attention_vector_bytes(),
                  getattr(lib, f"flash_attention_block_q_{sfx}")(),
                  getattr(lib, f"flash_attention_block_kv_{sfx}")())
        if limits != (MAX_HEAD_DIM, VECTOR_BYTES, *TILES[dtype]):
            raise RuntimeError(f"kernel library limits {limits} differ from "
                               f"the wrapper's for {dtype}")
    return fn


def misalignment(x: torch.Tensor) -> Optional[str]:
    """Why the kernels' 16-byte copies cannot stage ``x`` (its start, or
    a stride of a dim longer than 1, not a multiple of 16 bytes), or None
    when they can."""
    item = x.element_size()
    if x.data_ptr() % VECTOR_BYTES:
        return f"starts {x.data_ptr() % VECTOR_BYTES} bytes past a " \
               f"{VECTOR_BYTES}-byte boundary"
    for dim, (n, st) in enumerate(zip(x.shape[:-1], x.stride()[:-1])):
        if n > 1 and (st * item) % VECTOR_BYTES:
            return f"dim {dim} has a stride of {st * item} bytes, not a " \
                   f"multiple of {VECTOR_BYTES}"
    return None


def check_vectors(kernel: str, **tensors: torch.Tensor) -> None:
    """Raise where ``kernel``'s 16-byte copies cannot stage a tensor."""
    for name, x in tensors.items():
        why = misalignment(x)
        if why:
            raise ValueError(f"{name} {tuple(x.shape)} strides {x.stride()}: "
                             f"{why}; the {kernel} kernel stages rows in "
                             f"{VECTOR_BYTES}-byte copies")


def _check(q, k, v):
    """Validate what the CUDA kernel takes; raise on anything else."""
    if q.device.type != "cuda":
        raise ValueError(f"the flash kernel runs on CUDA tensors, got "
                         f"{q.device}")
    _check_layout(q, k, v)


def _check_layout(q, k, v):
    """Everything ``_check`` asks but the device: the meta route's
    check."""
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    if q.dtype not in _SUFFIX:
        raise TypeError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q {q.dtype}, k {k.dtype}, v {v.dtype}: the kernel "
                        f"takes one dtype")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, H, T, D) and k, v (B, H_kv, S, D), "
                         f"got {tuple(q.shape)} / {tuple(k.shape)} / "
                         f"{tuple(v.shape)}")
    b, h, t, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} does not fit k/v "
                         f"{tuple(k.shape)} (GQA needs H % H_kv == 0)")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"kernel takes head_dim <= {MAX_HEAD_DIM}, got {d}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1:
            raise ValueError(f"{name}: the head dim must be contiguous, got "
                             f"strides {x.stride()}")
    check_vectors("flash", q=q, k=k, v=v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    sm_scale: Optional[float] = None, q_offset: int = 0,
                    kv_len: Optional[int] = None, pe_rows: int = 1,
                    pe_stride: int = 0):
    """q (B, H, T, D); k, v (B, H_kv, S, D) with H % H_kv == 0, any
    strides with a contiguous last dim.  Returns ``(out, lse)``: out
    (B, H, T, D) in q's dtype with q's strides, lse (B, H, T) f32.
    Batch row ``b``'s queries sit at ``q_offset + (b // pe_rows) *
    pe_stride + i`` (module docstring)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   sm_scale=sm_scale, q_offset=q_offset,
                                   kv_len=kv_len, pe_rows=pe_rows,
                                   pe_stride=pe_stride)
    meta = q.device.type == "meta"        # the dry run's route
    (_check_layout if meta else _check)(q, k, v)
    check_pe(q.shape[0], pe_rows, pe_stride)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    b, h, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    sm_scale = 1.0 / math.sqrt(d) if sm_scale is None else sm_scale
    kv_len = s if kv_len is None else kv_len
    out = torch.empty_like(q)             # keeps q's strides (layout)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    if meta:
        META["calls"] += 1
        META["flops"] += flash_flops(b, h, t, s, d, causal=causal,
                                     window=window, q_offset=q_offset,
                                     kv_len=kv_len, pe_rows=pe_rows,
                                     pe_stride=pe_stride)
        META["bytes"] += (q.numel() + k.numel() + v.numel() + out.numel()) \
            * q.element_size() + lse.numel() * 4
        return out, lse
    if out.numel() == 0:
        return out, lse
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    fn = _kernel(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), b, h, hkv, t, s, d, strides, sm_scale,
                 int(causal), 0 if window is None else int(window),
                 int(q_offset), int(pe_rows), int(pe_stride), int(kv_len),
                 stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["flash_attention"] += 1
    return out, lse

