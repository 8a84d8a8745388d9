"""symm_copy — the POSH memory-copy engine (paper §4.4): a CUDA kernel for
Hopper, its plain PyTorch version, and the dispatch that picks a variant.

POSH ships several ``memcpy`` implementations and selects one at compile
time, because the copy between private and symmetric memory is the hot
spot of every put/get.  The reference's variants are VMEM block shapes
of a Pallas copy; the port keeps their names, the same size/dtype ladder
(``choose_variant``) and the same block shapes (``block_shape``), so that
dispatch and bench rows match the reference's one to one.  On the card
the block becomes the tile one CUDA block copies per step of its loop
over the payload (``csrc/symm_copy.cu``, which says what bounds the
kernel and what its design does about it): when source and destination
share their alignment modulo 16, Hopper's bulk copy engine (TMA) moves
the aligned bulk through a shared-memory ring, one block per SM
(``copy_plan`` cuts the payload into head, bulk and tail and sizes the
grid); otherwise a byte-by-byte path.

  * ``copy_blocked`` — the kernel wrapper; replaces the Pallas kernel
    ``repro.kernels.symm_copy.copy_blocked`` (body ``_copy_kernel``).
  * ``copy_blocked_ref`` — its plain version: the reference's own recipe
    (flatten, pad into a (rows, cols) panel tiled by the block, copy,
    slice back).
  * ``copy_stock`` — ``x.clone()``: a bare framework copy outside any
    kernel of ours, the reference's "stock".
  * ``copy(x, variant="auto")`` — the front door.

``copy_blocked`` takes the plain version only for a CPU tensor; for a
CUDA tensor it launches the kernel or raises.  ``LAUNCHES`` counts the
kernel's launches, and ``LAUNCHES_BY_PAYLOAD`` the same launches by
(bytes, dtype, variant), so that a run can price its copies.
"""
from __future__ import annotations

import ctypes
from collections import Counter

import torch

from . import build
from ..core.heap import torch_dtype
from ..device import sm_count

SOURCE = "symm_copy.cu"

# name -> (sublane rows, lane cols) of the reference's VMEM block (f32
# baseline; narrower dtypes round rows up to their sublane multiple)
VARIANTS: dict[str, tuple[int, int]] = {
    "vmem_8x128": (8, 128),        # minimal aligned tile ("MMX": small regs)
    "vmem_32x128": (32, 128),      # 16 KiB f32 blocks
    "vmem_64x256": (64, 256),      # 64 KiB
    "vmem_256x256": (256, 256),    # 256 KiB ("SSE": wide moves)
    "vmem_512x512": (512, 512),    # 1 MiB — few, large DMAs
}
DEFAULT_VARIANT = "vmem_256x256"

# dtype itemsize -> minimum sublane multiple of a VMEM tile
_SUBLANE = {8: 8, 4: 8, 2: 16, 1: 32}

# payload-size ladder for choose_variant (paper Table 1: the best memcpy
# depends on the buffer size, not just the ISA)
_SIZE_LADDER = (
    (32 << 10, "vmem_8x128"),      # <= 32 KiB
    (256 << 10, "vmem_32x128"),    # <= 256 KiB
    (1 << 20, "vmem_64x256"),      # <= 1 MiB
    (8 << 20, "vmem_256x256"),     # <= 8 MiB
)
_LADDER_TOP = "vmem_512x512"

# column panels per grid row for large payloads (the reference's 2-D
# panelization, kept in the plain version)
_MAX_COL_PANELS = 8

# grid cap of the byte path: 16 blocks of 256 threads per SM of the
# H100's 132; its grid-stride loop covers larger payloads
MAX_BLOCKS = 132 * 16
# the bulk path: bytes of a stage of each block's shared-memory ring (the
# most one bulk copy moves), and the alignment bulk copies need
STAGE_BYTES = 32 * 1024
BULK_ALIGN = 16

LAUNCHES = {"copy_blocked": 0}
LAUNCHES_BY_PAYLOAD: Counter = Counter()     # (nbytes, dtype, variant) -> n


def reset_launches() -> None:
    LAUNCHES["copy_blocked"] = 0
    LAUNCHES_BY_PAYLOAD.clear()


def _itemsize(dtype) -> int:
    return torch_dtype(dtype).itemsize


def block_shape(variant: str, dtype) -> tuple[int, int]:
    """The (rows, cols) block for ``variant`` under ``dtype``'s tiling
    constraint — rows rounded up to the dtype's sublane multiple (f32 8,
    bf16 16, int8 32), as the reference."""
    r, c = VARIANTS[variant]
    sub = _SUBLANE.get(_itemsize(dtype), 8)
    r = -(-r // sub) * sub
    return r, c


def choose_variant(nbytes: int, dtype=torch.float32) -> str:
    """Size/dtype dispatch: the variant whose block ladder the payload
    fills.  Payloads under one minimal tile go to "stock"."""
    item = _itemsize(dtype)
    sub = _SUBLANE.get(item, 8)
    if nbytes < sub * 128 * item:
        return "stock"
    for cap, name in _SIZE_LADDER:
        if nbytes <= cap:
            return name
    return _LADDER_TOP


def copy_blocked_ref(x: torch.Tensor, variant: str = DEFAULT_VARIANT
                     ) -> torch.Tensor:
    """The plain version, the reference's recipe: the flat payload padded
    into a (rows, cols) panel tiled exactly by the variant's block, the
    panel copied, the result sliced back."""
    r, c = block_shape(variant, x.dtype)
    flat = x.reshape(-1)
    n = flat.numel()
    row_blocks = -(-n // (r * c))
    col_panels = min(_MAX_COL_PANELS, max(1, row_blocks // _MAX_COL_PANELS))
    cols = c * col_panels
    rows = -(-n // cols)
    rows = -(-rows // r) * r
    panel = torch.cat([flat, flat.new_zeros(rows * cols - n)]).reshape(rows,
                                                                       cols)
    out = panel.clone()
    return out.reshape(-1)[:n].reshape(x.shape)


def copy_plan(src: int, dst: int, nbytes: int, tile_bytes: int,
              sms: int) -> tuple:
    """How the kernel copies ``nbytes`` (> 0) from address ``src`` to
    ``dst``: ``("bulk", head, n_bulk, grid)`` when the two share their
    alignment modulo 16 (and there are at least 32 bytes) — bytes [head,
    head + n_bulk) 16-byte aligned on both sides through the bulk copy
    engine, the fewer than 16 bytes before and after by block 0, one
    block per SM at most — else ``("bytes", 0, 0, grid)``."""
    n_tiles = -(-nbytes // tile_bytes)
    if (src - dst) % BULK_ALIGN or nbytes < 2 * BULK_ALIGN:
        return "bytes", 0, 0, min(n_tiles, MAX_BLOCKS)
    head = -src % BULK_ALIGN
    n_bulk = (nbytes - head) // BULK_ALIGN * BULK_ALIGN
    return "bulk", head, n_bulk, min(-(-n_bulk // tile_bytes), sms)


_FNS: dict = {}


def _kernel(path: str):
    if path not in _FNS:
        lib = build.load(SOURCE)
        if lib.symm_copy_stage_bytes() != STAGE_BYTES:
            raise RuntimeError("kernel library's stage bytes differ from "
                               "the wrapper's")
        fn = getattr(lib, f"symm_copy_{path}")
        ll = ctypes.c_longlong
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ll,
                       *((ll, ll) if path == "bulk" else ()), ll,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[path] = fn
    return _FNS[path]


def copy_blocked(x: torch.Tensor, variant: str = DEFAULT_VARIANT
                 ) -> torch.Tensor:
    """Identity copy of ``x`` (any dtype, treated as bytes) by the CUDA
    kernel, the variant's block as each CUDA block's tile; the plain
    version for a CPU tensor."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown copy variant {variant!r} "
                         f"(choose from {sorted(VARIANTS)})")
    if x.device.type == "cpu":
        return copy_blocked_ref(x, variant)
    if x.device.type != "cuda":
        raise ValueError(f"copy_blocked runs on CUDA tensors, got {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"copy_blocked takes a contiguous tensor, got "
                         f"strides {x.stride()} for shape {tuple(x.shape)}")
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    nbytes = x.numel() * x.element_size()
    if nbytes == 0:
        return out
    r, c = block_shape(variant, x.dtype)
    tile = r * c * x.element_size()
    path, head, n_bulk, grid = copy_plan(x.data_ptr(), out.data_ptr(),
                                         nbytes, tile, sm_count(x.device))
    fn = _kernel(path)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        bulk = (head, n_bulk) if path == "bulk" else ()
        err = fn(x.data_ptr(), out.data_ptr(), nbytes, *bulk, tile, grid,
                 stream)
    if err != 0:
        raise RuntimeError(f"copy_blocked kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["copy_blocked"] += 1
    LAUNCHES_BY_PAYLOAD[(nbytes, str(x.dtype).removeprefix("torch."),
                         variant)] += 1
    return out


def copy_stock(x: torch.Tensor) -> torch.Tensor:
    """The 'stock memcpy': a bare framework copy."""
    return x.clone()


def copy(x: torch.Tensor, variant: str = "auto") -> torch.Tensor:
    """The engine's front door: ``"auto"`` dispatches by the payload's
    bytes and dtype (``choose_variant``); a named variant pins the
    block, as POSH's ``-D`` flag pins the ISA; ``"stock"`` is the bare
    copy."""
    if variant == "auto":
        variant = choose_variant(x.numel() * x.element_size(), x.dtype)
    if variant == "stock":
        return copy_stock(x)
    return copy_blocked(x, variant)
