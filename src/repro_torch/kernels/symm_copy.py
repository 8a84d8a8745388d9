"""symm_copy — the POSH memory-copy engine (paper §4.4): a CUDA kernel for
Hopper, its plain PyTorch version, and the dispatch that picks a variant.

POSH ships several ``memcpy`` implementations and selects one at compile
time, because the copy between private and symmetric memory is the hot
spot of every put/get.  The reference's variants are VMEM block shapes
of a Pallas copy; the port keeps their names, the same size/dtype ladder
(``choose_variant``) and the same block shapes (``block_shape``), so that
dispatch and bench rows match the reference's one to one.  On the card
the block becomes the tile one CUDA block copies per step of its
grid-stride loop (``csrc/symm_copy.cu``, which says what bounds the
kernel and what its design does about it).

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
kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from ..core.heap import torch_dtype

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

# grid cap of the kernel: 16 blocks of 256 threads per SM of the H100's
# 132; the grid-stride loop covers larger payloads
MAX_BLOCKS = 132 * 16

LAUNCHES = {"copy_blocked": 0}


def reset_launches() -> None:
    LAUNCHES["copy_blocked"] = 0


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


_FN = None


def _kernel():
    global _FN
    if _FN is None:
        fn = build.load(SOURCE).symm_copy
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


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
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), nbytes,
                 r * c * x.element_size(), MAX_BLOCKS, stream)
    if err != 0:
        raise RuntimeError(f"copy_blocked kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["copy_blocked"] += 1
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
