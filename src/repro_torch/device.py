"""Device resolution for the port's entry points.

The port runs on the card.  ``resolve(None)`` is CUDA, and asking for
CUDA on a machine without a usable GPU raises — an entry point never
carries on silently on the CPU.  The CPU is reached only by asking for
it (``device="cpu"``), which is what the tests do; ``"meta"`` (shapes
and dtypes, no storage) is what the dry run (``launch.dryrun``) asks
for.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA GPU and none is available; pass "
            "device='cpu' explicitly to run the plain CPU versions")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def dtype_of(name: Optional[str]) -> torch.dtype:
    """``bf16`` | ``f32`` -> the torch dtype (CLI spelling)."""
    table = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
             "f32": torch.float32, "float32": torch.float32}
    if name not in table:
        raise ValueError(f"dtype must be bf16 or f32, got {name!r}")
    return table[name]


@lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (read once per device):
    what the kernels size their grids by."""
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())
