"""Public entry points over the port's kernels (counterpart of
``repro.kernels.ops``).

Each calls a kernel wrapper: the CUDA kernel for a CUDA tensor, the
plain version only for a CPU tensor.  The paged-attention entry points
keep the reference's ``impl`` switch (``impl="ref"`` calls the plain
PyTorch version on any device; the two are numerically interchangeable
within the tolerances the tests state).
"""
from __future__ import annotations

from . import flash_attention as _fa
from . import paged_attention as _pa
from . import reduce_combine as _rc
from . import symm_copy as _sc

PAGED_ATTN_IMPLS = ("kernel", "ref")
COPY_VARIANTS = tuple(["stock", "auto"] + list(_sc.VARIANTS))
COMBINE_VARIANTS = tuple(_rc.VARIANTS)


def symm_copy(x, variant: str = _sc.DEFAULT_VARIANT):
    """The copy engine: ``variant`` may be a block name, "stock" (bare
    copy) or "auto" (size/dtype dispatch on ``x``'s bytes)."""
    return _sc.copy(x, variant)


def combine(a, b, op: str = "sum", variant: str = _rc.DEFAULT_VARIANT):
    """Elementwise ``op(a, b)`` (sum/prod/max/min) by the combine kernel."""
    return _rc.combine_blocked(a, b, op, variant)


def attention(q, k, v, causal: bool = True, window=None, sm_scale=None):
    """Blocked causal/windowed GQA attention: q (B, H, T, D), k/v
    (B, H_kv, S, D) -> (B, H, T, D).  The kernel keeps its own tiles, so
    the reference's ``block_q``/``block_kv`` have no counterpart here."""
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               sm_scale=sm_scale)[0]


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
