"""Public entry points over the paged-attention kernels, with the
reference's ``impl`` switch.

``impl="kernel"`` calls the kernel wrapper (the CUDA kernel for a CUDA
tensor; the plain version only for a CPU tensor); ``impl="ref"`` calls
the plain PyTorch version on any device.  The two are numerically
interchangeable within the tolerances the tests state.
"""
from __future__ import annotations

from . import paged_attention as _pa

PAGED_ATTN_IMPLS = ("kernel", "ref")


def _check_impl(impl: str) -> None:
    if impl not in PAGED_ATTN_IMPLS:
        raise ValueError(f"paged attention impl='{impl}' "
                         f"(choose from {PAGED_ATTN_IMPLS})")


def paged_attention(q, k_pages, v_pages, block_tables, lengths,
                    impl: str = "kernel"):
    """Paged decode attention (serving hot path)."""
    _check_impl(impl)
    fn = _pa.paged_decode_attention_ref if impl == "ref" \
        else _pa.paged_decode_attention
    return fn(q, k_pages, v_pages, block_tables, lengths)


def paged_prefill_attention(q, k_pages, v_pages, block_tables, start, n_tok,
                            impl: str = "kernel"):
    """Chunk-window attention through a block table (chunked prefill)."""
    _check_impl(impl)
    fn = _pa.paged_prefill_attention_ref if impl == "ref" \
        else _pa.paged_prefill_attention
    return fn(q, k_pages, v_pages, block_tables, start, n_tok)
