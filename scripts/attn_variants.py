#!/usr/bin/env python3
"""Time source variants of the port's attention kernels on the card.

    python3 scripts/attn_variants.py [--out FILE]

Each variant is the checkout's ``src/repro_torch/kernels/csrc`` with one
edit — a tile constant, an unroll count, the mask skipped on tiles a
warp sees whole, the exp2 instruction — built into its own directory
under ``build/attn_variants/`` and timed with chip_smoke's ``time_ms``
at chip_smoke's shapes: the flash kernel at the training shape in f32
and bf16, and the bf16 paged prefill at the timing shape.  Every
variant runs twice, the second pass in reverse order, each time beside
its max |kernel - plain|.  It records why the committed kernels are as
they are; the kernels' own numbers come from ``chip_smoke.py``.  Needs
one CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

FLASH, PAGED = "flash_attention.cu", "paged_attention.cu"
SCORE_LOOP = "#pragma unroll 2\n    for (int d = 0; d < DP; d += 4) {"
BF16_TILE = "constexpr int B_BQ = 128, B_BKV = 64, B_THREADS = 256;"
SOFTMAX = "      float mx0 = NEG_INF, mx1 = NEG_INF;\n"
FLASH_MASK = ("s[j][e] = visible(row, col, causal, window, kv_len) ? "
              "s[j][e] * scale2 : NEG_INF;")
PAGED_MASK = "s[j][e] = t < (e < 2 ? lim_a : lim_b) ? s[j][e] * scale2 : NEG_INF;"
PAGED_REMASK = "const bool ok = t < (e < 2 ? lim_a : lim_b);"
WALK = ("  const int warp_walk = __reduce_max_sync(0xffffffffu, "
        "max(lim_a, lim_b));\n")
EX2 = ("__device__ __forceinline__ float ex2f(float x) {\n  float y;\n"
       '  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));\n'
       "  return y;\n}\n")

# name -> ({source: [(old, new), ...]}, bf16 flash tiles or None)
VARIANTS = {
    "committed": ({}, None),
    "f32_score_loop_not_unrolled": (
        {FLASH: [(SCORE_LOOP, SCORE_LOOP.replace("unroll 2", "unroll 1"))]},
        None),
    "bf16_q64_rows_4_warps": (
        {FLASH: [(BF16_TILE, "constexpr int B_BQ = 64, B_BKV = 64, "
                             "B_THREADS = 128;")]}, (64, 64)),
    "mask_skipped_on_whole_tiles": (
        {FLASH: [(SOFTMAX, "      const bool whole = k0 + B_BKV <= kv_len && "
                           "(!causal || k0 + B_BKV - 1 <= wrow) && (window <= "
                           "0 || k0 > wrow + 15 - window);\n" + SOFTMAX),
                 (FLASH_MASK, "s[j][e] = whole || visible(row, col, causal, "
                              "window, kv_len) ? s[j][e] * scale2 : NEG_INF;")],
         PAGED: [(WALK, WALK + "  const int warp_seen = __reduce_min_sync("
                               "0xffffffffu, min(lim_a, lim_b));\n"),
                 (SOFTMAX, "      const bool whole = t0 + PF_TOKENS <= "
                           "warp_seen;\n" + SOFTMAX),
                 (PAGED_MASK, "s[j][e] = whole || t < (e < 2 ? lim_a : lim_b)"
                              " ? s[j][e] * scale2 : NEG_INF;"),
                 (PAGED_REMASK, "const bool ok = whole || t < (e < 2 ? lim_a "
                                ": lim_b);")]}, None),
    "ex2_approx_ftz": (
        {src: [("using namespace hopper;\n", "using namespace hopper;\n" + EX2),
               ("exp2f(", "ex2f(")] for src in (FLASH, PAGED)}, None),
}


def variant_dir(csrc: Path, name: str) -> Path:
    """The committed sources with the variant's edits, in their own
    directory (each edit's old text must be there)."""
    edits, _ = VARIANTS[name]
    out = ROOT / "build" / "attn_variants" / name
    out.mkdir(parents=True, exist_ok=True)
    for f in csrc.glob("*.cu*"):
        text = f.read_text()
        for old, new in edits.get(f.name, []):
            if old not in text:
                raise RuntimeError(f"{name}: {f.name} has no {old!r}")
            text = text.replace(old, new)
        (out / f.name).write_text(text)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the rows as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attn_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card, flush=True)
    csrc, tiles = build.CSRC, dict(fa.TILES)
    inputs = {dt: cs.flash_inputs(cs.FLASH_FULL, dt, dev)
              for dt in (torch.float32, torch.bfloat16)}
    refs = {dt: fa.flash_attention_ref(*x, causal=True)
            for dt, x in inputs.items()}
    pcase = cs.prefill_case(torch.bfloat16, dev)
    pref = pa.paged_prefill_attention_ref(*pcase)
    rows = []
    for order in (list(VARIANTS), list(VARIANTS)[::-1]):
        for name in order:
            build.CSRC = variant_dir(csrc, name)
            build._LOADED.clear()
            fa.TILES[torch.bfloat16] = VARIANTS[name][1] or \
                tiles[torch.bfloat16]
            row = {"variant": name}
            for dt, (q, k, v) in inputs.items():
                tag = "f32" if dt == torch.float32 else "bf16"
                out, lse = fa.flash_attention(q, k, v, causal=True)
                ref, ref_lse = refs[dt]
                row[f"flash_{tag}_err"] = max(
                    (out.float() - ref.float()).abs().max().item(),
                    (lse - ref_lse).abs().max().item())
                row[f"flash_{tag}_ms"] = cs.time_ms(
                    lambda: fa.flash_attention(q, k, v, causal=True), dev)
            got = pa.paged_prefill_attention(*pcase)
            row["prefill_bf16_err"] = (got.float() - pref.float()).abs() \
                .max().item()
            row["prefill_bf16_ms"] = cs.time_ms(
                lambda: pa.paged_prefill_attention(*pcase), dev)
            rows.append(row)
            print(json.dumps(row), flush=True)
    build.CSRC, fa.TILES = csrc, tiles
    build._LOADED.clear()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)
    shutil.rmtree(ROOT / "build" / "attn_variants", ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
