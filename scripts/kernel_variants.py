#!/usr/bin/env python3
"""Time source variants of the port's hand-written kernels on the card.

    python3 scripts/kernel_variants.py [--group attention|decode|copy ...]
                                        [--out FILE]

Each variant is the checkout's ``src/repro_torch/kernels/csrc`` with
edits to its sources, built into its own directory under
``build/kernel_variants/`` and timed with chip_smoke's ``time_ms`` at
chip_smoke's shapes.  The groups:

  * ``attention`` — a tile constant, an unroll count, the mask skipped on
    tiles a warp sees whole, the exp2 instruction; the flash kernel at
    the training shape in f32 and bf16 and the bf16 paged prefill at the
    timing shape, each beside its max |kernel - plain|;
  * ``decode`` — the bf16 paged decode's partition (64 tokens over 4
    warps instead of 128 over 8), the partitions a merging thread loads
    at once, and the merge done by the block of the last partition,
    which spins until the others have counted themselves (it relies on
    blocks being dispatched in grid order); timed at chip_smoke's decode
    timing shape and at 8 sequences of 4096 tokens, each beside its max
    |kernel - plain| and chip_smoke's check at 4096 tokens (absolute and
    as a share of max |plain|).  One more variant, a merge that leaves
    out each sequence's partition 0, is a broken kernel: its row shows
    what the two checks make of it;
  * ``copy`` — the copy engine's ring (stage size and depth), an L2
    evict-first hint on the bulk copies, every block waiting for its
    stores to complete before it ends, or the bulk path swapped for a
    plain vector copy (16-byte ``ld.global.nc`` loads and
    ``st.global.cs`` stores, 8 in flight per thread, 8 blocks of 256
    threads per SM); timed beside ``x.clone()`` at three staged f32
    payloads of the comm path (8 x 64 KiB, 8 x 1 MiB, 8 x 8 MiB), each
    with the variant the stager picks, and checked bit for bit.

Every variant runs twice, the second pass in reverse order.  It records
why the committed kernels are as they are; the kernels' own numbers come
from ``chip_smoke.py``.  It exits 1 if a variant does not build or the
committed kernels fail a check.  Needs one CUDA card; imports nothing of
JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
from functools import partial
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

FLASH, PAGED, COPY = "flash_attention.cu", "paged_attention.cu", "symm_copy.cu"

# -- attention: the flash kernel and the bf16 paged prefill ------------
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

# -- decode: the bf16 paged decode -------------------------------------
PARTITION = ("constexpr int DEC_TOKENS = 128;",
             "constexpr int DEC_BLOCKS_PER_SM = 3;")
TICKET = ("  __shared__ int last_s;\n"
          "  __syncthreads();\n"
          "  if (tid == 0) last_s = atom_add_acq_rel(tickets + bh, 1) == "
          "n_p - 1;\n"
          "  __syncthreads();\n"
          "  if (!last_s) return;\n")
SPIN = ("  __syncthreads();\n"
        "  if (part < n_p - 1) {\n"
        "    if (tid == 0)\n"
        '      asm volatile("red.release.gpu.global.add.s32 [%0], 1;\\n" '
        '::"l"(tickets + bh) : "memory");\n'
        "    return;\n"
        "  }\n"
        "  if (tid == 0)\n"
        "    for (;;) {\n"
        "      int c;\n"
        '      asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\\n" : "=r"(c) '
        ': "l"(tickets + bh) : "memory");\n'
        "      if (c >= n_p - 1) break;\n"
        "      __nanosleep(32);\n"
        "    }\n"
        "  __syncthreads();\n")
MERGE_WEIGHT = "const float cj = j0 + u < jb ? exp2f(mj[u] - mb) : 0.f;"

# -- copy: the copy engine ---------------------------------------------
PAYLOADS = [(8, 16 << 10), (8, 256 << 10), (8, 2 << 20)]      # f32 elems
RING = ("constexpr int STAGE_BYTES = 32 * 1024;\n"
        "constexpr int STAGES = 6;                 // a 192 KiB ring per block\n")
EXIT_WAIT = ("  bulk_wait_read<0>();                    // the ring is free: "
             "the block may end\n")
FULL_WAIT = ('  asm volatile("cp.async.bulk.wait_group 0;\\n" ::: "memory");\n')
LAUNCH = ("  copy_bulk_kernel<<<grid, BULK_THREADS, RING_BYTES, "
          "(cudaStream_t)stream>>>(\n")
NAMESPACE_END = "}  // namespace\n"
VECTOR_KERNEL = r'''
constexpr int VTHREADS = 256, VUNROLL = 8, VBLOCKS_PER_SM = 8;

__global__ void __launch_bounds__(VTHREADS)
copy_vec_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                long long nbytes, long long head, long long n_bulk, long long tile_bytes) {
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    const long long tail = head + n_bulk;
    if (threadIdx.x < head) dst[threadIdx.x] = src[threadIdx.x];
    if (tail + threadIdx.x < nbytes) dst[tail + threadIdx.x] = src[tail + threadIdx.x];
  }
  const uint4* s = reinterpret_cast<const uint4*>(src + head);
  uint4* d = reinterpret_cast<uint4*>(dst + head);
  const long long n_vec = n_bulk / 16, tile = tile_bytes / 16;
  const long long n_tiles = (n_vec + tile - 1) / tile;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long lo = t * tile, hi = lo + tile < n_vec ? lo + tile : n_vec;
    for (long long i = lo + threadIdx.x; i < hi; i += (long long)VTHREADS * VUNROLL) {
      uint4 v[VUNROLL];
#pragma unroll
      for (int u = 0; u < VUNROLL; ++u) {
        const long long j = i + (long long)u * VTHREADS;
        if (j < hi) v[u] = __ldg(s + j);
      }
#pragma unroll
      for (int u = 0; u < VUNROLL; ++u) {
        const long long j = i + (long long)u * VTHREADS;
        if (j < hi) __stcs(d + j, v[u]);
      }
    }
  }
}

'''
VECTOR_LAUNCH = (
    "  int dev = 0, sms = 0;\n"
    "  cudaGetDevice(&dev);\n"
    "  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);\n"
    "  const long long tiles = (n_bulk + tile_bytes - 1) / tile_bytes;\n"
    "  grid = (int)(tiles < (long long)sms * VBLOCKS_PER_SM ? tiles\n"
    "               : (long long)sms * VBLOCKS_PER_SM);\n"
    "  copy_vec_kernel<<<grid, VTHREADS, 0, (cudaStream_t)stream>>>(\n")
LOAD = ('      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes '
        '[%0], [%1], %2, [%3];\\n" ::\n')
STORE = ('  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], '
         '[%1], %2;\\n" ::"l"(dst),\n')
POLICY = ('"{\\n.reg .b64 pol;\\n'
          'createpolicy.fractional.L2::evict_first.b64 pol, 1.0;\\n"\n')
EVICT_FIRST = [
    (LOAD, '      ' + POLICY + '      "cp.async.bulk.shared::cluster.global.'
     'mbarrier::complete_tx::bytes.L2::cache_hint [%0], [%1], %2, [%3], pol;'
     '\\n}\\n" ::\n'),
    (STORE, '  asm volatile(' + POLICY + '      "cp.async.bulk.global.'
     'shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, pol;\\n}\\n" '
     '::"l"(dst),\n')]


def _ring(stage_kib: int, stages: int) -> str:
    return (f"constexpr int STAGE_BYTES = {stage_kib} * 1024;\n"
            f"constexpr int STAGES = {stages};\n")


# group -> name -> ({source: [(old, new), ...]}, wrapper settings)
VARIANTS = {
    "attention": {
        "committed": ({}, {}),
        "f32_score_loop_not_unrolled": (
            {FLASH: [(SCORE_LOOP, SCORE_LOOP.replace("unroll 2",
                                                     "unroll 1"))]}, {}),
        "bf16_q64_rows_4_warps": (
            {FLASH: [(BF16_TILE, "constexpr int B_BQ = 64, B_BKV = 64, "
                                 "B_THREADS = 128;")]},
            {"bf16_tiles": (64, 64)}),
        "mask_skipped_on_whole_tiles": (
            {FLASH: [(SOFTMAX, "      const bool whole = k0 + B_BKV <= kv_len"
                               " && (!causal || k0 + B_BKV - 1 <= wrow) && "
                               "(window <= 0 || k0 > wrow + 15 - window);\n"
                               + SOFTMAX),
                     (FLASH_MASK, "s[j][e] = whole || visible(row, col, "
                                  "causal, window, kv_len) ? s[j][e] * "
                                  "scale2 : NEG_INF;")],
             PAGED: [(WALK, WALK + "  const int warp_seen = __reduce_min_sync("
                                   "0xffffffffu, min(lim_a, lim_b));\n"),
                     (SOFTMAX, "      const bool whole = t0 + PF_TOKENS <= "
                               "warp_seen;\n" + SOFTMAX),
                     (PAGED_MASK, "s[j][e] = whole || t < (e < 2 ? lim_a : "
                                  "lim_b) ? s[j][e] * scale2 : NEG_INF;"),
                     (PAGED_REMASK, "const bool ok = whole || t < (e < 2 ? "
                                    "lim_a : lim_b);")]}, {}),
        "ex2_approx_ftz": (
            {src: [("using namespace hopper;\n",
                    "using namespace hopper;\n" + EX2),
                   ("exp2f(", "ex2f(")] for src in (FLASH, PAGED)}, {}),
    },
    "decode": {
        "committed": ({}, {}),
        "last_partition_spins_for_the_count": ({PAGED: [(TICKET, SPIN)]}, {}),
        "partition_64_tokens_4_warps": (
            {PAGED: [(PARTITION[0], "constexpr int DEC_TOKENS = 64;"),
                     (PARTITION[1], "constexpr int DEC_BLOCKS_PER_SM = 6;")]},
            {"DECODE_TOKENS": 64}),
        "merge_batch_8": ({PAGED: [("constexpr int MERGE_BATCH = 4;",
                                    "constexpr int MERGE_BATCH = 8;")]}, {}),
        "broken_merge_leaves_out_partition_0": (
            {PAGED: [(MERGE_WEIGHT, MERGE_WEIGHT.replace(
                "j0 + u < jb", "j0 + u < jb && j0 + u > 0"))]}, {}),
    },
    "copy": {
        "committed": ({}, {}),
        "ring_4x32KiB": ({COPY: [(RING, _ring(32, 4))]}, {}),
        "ring_7x32KiB": ({COPY: [(RING, _ring(32, 7))]}, {}),
        "ring_12x16KiB": ({COPY: [(RING, _ring(16, 12))]},
                          {"STAGE_BYTES": 16 << 10}),
        "ring_3x64KiB": ({COPY: [(RING, _ring(64, 3))]},
                         {"STAGE_BYTES": 64 << 10}),
        "l2_evict_first": ({COPY: EVICT_FIRST}, {}),
        "stores_complete_before_exit": ({COPY: [(EXIT_WAIT, FULL_WAIT)]}, {}),
        "plain_vector_nc_cs": ({COPY: [(NAMESPACE_END,
                                        VECTOR_KERNEL + NAMESPACE_END),
                                       (LAUNCH, VECTOR_LAUNCH)]}, {}),
    },
}
SOURCES = {"attention": (FLASH, PAGED), "decode": (PAGED,), "copy": (COPY,)}


def variant_dir(csrc: Path, group: str, name: str) -> Path:
    """The committed sources with the variant's edits, in their own
    directory (each edit's old text must be there)."""
    edits, _ = VARIANTS[group][name]
    out = ROOT / "build" / "kernel_variants" / f"{group}-{name}"
    out.mkdir(parents=True, exist_ok=True)
    for f in csrc.glob("*.cu*"):
        text = f.read_text()
        for old, new in edits.get(f.name, []):
            if old not in text:
                raise RuntimeError(f"{name}: {f.name} has no {old!r}")
            text = text.replace(old, new)
        (out / f.name).write_text(text)
    return out


def attention_row(cs, fa, pa, dev, data) -> tuple:
    row, ok = {}, True
    for dt, ((q, k, v), (ref, ref_lse)) in data["flash"].items():
        tag = "f32" if dt == torch.float32 else "bf16"
        out, lse = fa.flash_attention(q, k, v, causal=True)
        err = max((out.float() - ref.float()).abs().max().item(),
                  (lse - ref_lse).abs().max().item())
        row[f"flash_{tag}_err"] = err
        ok &= err <= cs.TOL[dt]
        row[f"flash_{tag}_ms"] = cs.time_ms(
            lambda: fa.flash_attention(q, k, v, causal=True), dev)
    pcase, pref = data["prefill"]
    got = pa.paged_prefill_attention(*pcase)
    row["prefill_bf16_err"] = (got.float() - pref.float()).abs().max().item()
    ok &= row["prefill_bf16_err"] <= cs.TOL[torch.bfloat16]
    row["prefill_bf16_ms"] = cs.time_ms(
        lambda: pa.paged_prefill_attention(*pcase), dev)
    return row, ok


def decode_row(cs, pa, dev, data) -> tuple:
    row, ok = {}, True
    tol = cs.TOL[torch.bfloat16]
    for tag, (args, ref) in data.items():
        got = pa.paged_decode_attention(*args)
        again = pa.paged_decode_attention(*args)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        row[f"{tag}_err"] = err
        row[f"{tag}_same_bits"] = torch.equal(got, again)
        ok &= err <= tol and row[f"{tag}_same_bits"]
        if tag == "long":
            row["long_max_abs_plain"] = scale
            row["long_abs_check"] = err <= tol
            row["long_scaled_check"] = err <= cs.SCALE_TOL * scale
            ok &= row["long_scaled_check"]
        row[f"{tag}_ms"] = cs.time_ms(
            lambda: pa.paged_decode_attention(*args), dev)
    return row, ok


def copy_row(cs, sc, dev, xs) -> tuple:
    row, ok = {}, True
    for x in xs:
        variant = sc.choose_variant(x[0].numel() * 4, x.dtype)
        got = sc.copy_blocked(x, variant)
        torch.cuda.synchronize()
        tag = f"{x.numel() * 4}B"
        row[f"{tag}_bit_exact"] = torch.equal(got.view(torch.int32),
                                              x.view(torch.int32))
        ok &= row[f"{tag}_bit_exact"]
        row[f"{tag}_ms"] = cs.time_ms(lambda: sc.copy_blocked(x, variant), dev)
        row[f"{tag}_clone_ms"] = cs.time_ms(lambda: x.clone(), dev)
    return row, ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--group", nargs="+", choices=sorted(VARIANTS),
                    default=sorted(VARIANTS), help="the groups to time")
    ap.add_argument("--out", default=None, help="write the rows as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import symm_copy as sc

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card, flush=True)
    csrc = build.CSRC
    saved = {"bf16_tiles": fa.TILES[torch.bfloat16],
             "DECODE_TOKENS": pa.DECODE_TOKENS,
             "STAGE_BYTES": sc.STAGE_BYTES}

    def settle(settings: dict) -> None:
        s = {**saved, **settings}
        fa.TILES[torch.bfloat16] = s["bf16_tiles"]
        pa.DECODE_TOKENS = s["DECODE_TOKENS"]
        sc.STAGE_BYTES = s["STAGE_BYTES"]
        build._LOADED.clear()
        sc._FNS.clear()

    rows, rc = [], 0
    for group in args.group:
        if group == "attention":
            data = {"flash": {}, "prefill": None}
            for dt in (torch.float32, torch.bfloat16):
                x = cs.flash_inputs(cs.FLASH_FULL, dt, dev)
                data["flash"][dt] = (x, fa.flash_attention_ref(*x,
                                                               causal=True))
            pcase = cs.prefill_case(torch.bfloat16, dev)
            data["prefill"] = (pcase, pa.paged_prefill_attention_ref(*pcase))
            measure = partial(attention_row, cs, fa, pa, dev, data)
        elif group == "decode":
            data = {}
            for tag, make in (("timing", cs.decode_case),
                              ("long", cs.decode_long_case)):
                case = make(torch.bfloat16, dev)
                data[tag] = (case, pa.paged_decode_attention_ref(*case))
            measure = partial(decode_row, cs, pa, dev, data)
        else:
            data = [torch.randn(shape, device=dev) for shape in PAYLOADS]
            measure = partial(copy_row, cs, sc, dev, data)
        names = list(VARIANTS[group])
        for order in (names, names[::-1]):
            for name in order:
                build.CSRC = variant_dir(csrc, group, name)
                settle(VARIANTS[group][name][1])
                row = {"group": group, "variant": name}
                try:
                    for source in SOURCES[group]:
                        build.load(source)
                except RuntimeError as e:        # a variant nvcc refuses
                    row["build_error"] = str(e)[-2000:]
                    rc = 1
                else:
                    got, ok = measure()
                    row.update(got, checks_pass=ok)
                    if name == "committed" and not ok:
                        rc = 1
                rows.append(row)
                print(json.dumps(row), flush=True)
        del data, measure
        torch.cuda.empty_cache()
    build.CSRC = csrc
    settle({})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)
    shutil.rmtree(ROOT / "build" / "kernel_variants", ignore_errors=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
