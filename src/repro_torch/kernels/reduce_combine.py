"""reduce_combine — the elementwise combine of the ring reductions: a CUDA
kernel for Hopper, its plain PyTorch version and the wrapper.

``combine_blocked(a, b, op)`` is ``op(a, b)`` elementwise for ``sum``,
``prod``, ``max`` and ``min``; it replaces the Pallas kernel
``repro.kernels.reduce_combine.combine_blocked`` (body
``_combine_kernel``) and raises ``ValueError`` on the same mismatches
(shape, dtype, unknown op).  The variant's block is the tile one CUDA
block combines per step of its grid-stride loop; the grid is sized to
the card (:func:`combine_grid`), and each thread keeps several 16-byte
vector pairs in flight (``csrc/reduce_combine.cu``, which says what
bounds the kernel).  The kernel takes float32, bfloat16 and int32 —
bf16 computed in f32 and rounded once, max/min propagating NaN, as
PyTorch does.

The wrapper takes the plain version only for a CPU tensor; for a CUDA
tensor it launches the kernel or raises.  ``LAUNCHES`` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from ..device import sm_count

SOURCE = "reduce_combine.cu"

_OPS = {
    "sum": torch.add,
    "prod": torch.mul,
    "max": torch.maximum,
    "min": torch.minimum,
}
_OP_CODE = {"sum": 0, "prod": 1, "max": 2, "min": 3}

VARIANTS: dict[str, tuple[int, int]] = {
    "vmem_8x128": (8, 128),
    "vmem_64x256": (64, 256),
    "vmem_256x256": (256, 256),
}
DEFAULT_VARIANT = "vmem_64x256"

# blocks of the kernel's THREADS threads per SM (what its registers let
# an SM hold at once): the grid is the card's SMs times this, or the
# call's tile count where that is smaller; each thread keeps UNROLL
# 16-byte vector pairs in flight (checked against the library's at load)
BLOCKS_PER_SM = 8
THREADS = 128
UNROLL = 4
VECTOR_BYTES = 16

LAUNCHES = {"combine_blocked": 0}

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int32: "i32"}
_FNS: dict = {}


def reset_launches() -> None:
    LAUNCHES["combine_blocked"] = 0


def _check(a: torch.Tensor, b: torch.Tensor, op: str, variant: str) -> None:
    if a.shape != b.shape or a.dtype != b.dtype:
        raise ValueError(f"operand mismatch: {tuple(a.shape)}/{a.dtype} vs "
                         f"{tuple(b.shape)}/{b.dtype}")
    if op not in _OPS:
        raise ValueError(f"unknown combine op '{op}'")
    if variant not in VARIANTS:
        raise ValueError(f"unknown combine variant {variant!r} "
                         f"(choose from {sorted(VARIANTS)})")


def combine_blocked_ref(a: torch.Tensor, b: torch.Tensor, op: str = "sum",
                        variant: str = DEFAULT_VARIANT) -> torch.Tensor:
    """The plain version: the PyTorch elementwise op."""
    _check(a, b, op, variant)
    return _OPS[op](a, b)


def vector_path(*tensors: torch.Tensor) -> bool:
    """Whether the kernel takes its 16-byte path: every pointer 16-byte
    aligned (else it runs element by element)."""
    return all(t.data_ptr() % VECTOR_BYTES == 0 for t in tensors)


def combine_grid(n: int, itemsize: int, variant: str, vector: bool,
                 sms: int) -> int:
    """Blocks of a combine launch over ``n`` elements: ``BLOCKS_PER_SM``
    per SM, or one per tile of the variant where the call has fewer
    tiles (each block walks tiles grid-stride), at least one (block 0
    also takes the tail of fewer than one vector)."""
    r, c = VARIANTS[variant]
    vec = VECTOR_BYTES // itemsize if vector else 1
    tile_units = max((r * c) // vec, 1)
    n_tiles = -(-(n // vec) // tile_units)
    return max(1, min(n_tiles, BLOCKS_PER_SM * sms))


def _kernel(dtype: torch.dtype):
    fn = _FNS.get(dtype)
    if fn is None:
        lib = build.load(SOURCE)
        step = (lib.combine_threads(), lib.combine_unroll())
        if step != (THREADS, UNROLL):
            raise RuntimeError(f"kernel library's threads and unroll {step} "
                               f"differ from the wrapper's "
                               f"{(THREADS, UNROLL)}")
        fn = getattr(lib, f"combine_{_SUFFIX[dtype]}")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[dtype] = fn
    return fn


def combine_blocked(a: torch.Tensor, b: torch.Tensor, op: str = "sum",
                    variant: str = DEFAULT_VARIANT) -> torch.Tensor:
    """Elementwise ``op(a, b)``: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    _check(a, b, op, variant)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return combine_blocked_ref(a, b, op, variant)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"combine_blocked runs on CUDA tensors of one "
                         f"device, got {a.device} and {b.device}")
    if a.dtype not in _SUFFIX:
        raise TypeError(f"the combine kernel takes float32, bfloat16 or "
                        f"int32, got {a.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("combine_blocked takes contiguous operands")
    out = torch.empty_like(a, memory_format=torch.contiguous_format)
    n = a.numel()
    if n == 0:
        return out
    r, c = VARIANTS[variant]
    vector = vector_path(a, b, out)
    grid = combine_grid(n, a.element_size(), variant, vector,
                        sm_count(a.device))
    fn = _kernel(a.dtype)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, _OP_CODE[op],
                 r * c, int(vector), grid, stream)
    if err != 0:
        raise RuntimeError(f"combine_blocked kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["combine_blocked"] += 1
    return out
