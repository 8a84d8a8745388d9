#!/usr/bin/env python3
"""Time source variants of the port's hand-written kernels on the card.

    python3 scripts/kernel_variants.py [--group attention|decode|
                                         decode_f32|copy|prefill_f32|
                                         combine ...]
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
  * ``decode_f32`` — the f32 paged decode's partition (128 tokens instead
    of 64), the partitions a merging thread loads at once (4, 8), the
    broken merge above, and the design this one replaced (a split of
    each sequence over blocks of 8 warps, token by token, then a
    merge kernel) restored as it was; three diagnostic variants each
    take one phase out (the ticket and merge, P V, the V loads), so
    they give wrong outputs and fail the checks, and their times show
    what that phase costs; timed at chip_smoke's decode
    timing shape, at 8 sequences of 4096 tokens and at the timing
    shape's lengths on the serve path's 256-slot table (most of its
    blocks exit at once), each beside its max |kernel - plain| (within
    chip_smoke's f32 decode tolerance, and at 4096 tokens within its
    share of max |plain|) and whether two calls give the same bits;
  * ``copy`` — the copy engine's ring (stage size and depth), an L2
    evict-first hint on the bulk copies, every block waiting for its
    stores to complete before it ends, or the bulk path swapped for a
    plain vector copy (16-byte ``ld.global.nc`` loads and
    ``st.global.cs`` stores, 8 in flight per thread, 8 blocks of 256
    threads per SM); timed beside ``x.clone()`` at three staged f32
    payloads of the comm path (8 x 64 KiB, 8 x 1 MiB, 8 x 8 MiB), each
    with the variant the stager picks, and checked bit for bit.

  * ``prefill_f32`` — the f32 paged prefill body: one token group
    instead of two, tiles of 32 tokens, four groups of 32-token tiles,
    blocks in grid order, and the body this design replaced (a warp per
    8 score rows, token by token) restored as it was; timed at
    chip_smoke's f32 timing window and at 8 windows
    of 64 rows at positions 900-963, each beside its max |kernel -
    plain|;
  * ``combine`` — the combine's vector pairs in flight per thread (2, 8),
    16 blocks per SM, blocks of 256 threads 4 per SM (with 4 or 8 pairs),
    read-once loads and streaming stores in place of plain ones, and the
    design this one replaced (one pair a thread, a block of 256 per tile
    up to 16 per SM); timed beside ``torch.add`` at chip_smoke's 8 x 8
    MiB f32 payload in the default variant, ``vmem_8x128`` and
    ``vmem_256x256``, checked bit for bit.

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
COMBINE = "reduce_combine.cu"

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
          "  if (tid == 0) last_s = atom_add_acq_rel(ticket, 1) == n_p - 1;\n"
          "  __syncthreads();\n"
          "  if (!last_s) return;\n")
SPIN = ("  __syncthreads();\n"
        "  if ((int)blockIdx.z < n_p - 1) {\n"
        "    if (tid == 0)\n"
        '      asm volatile("red.release.gpu.global.add.s32 [%0], 1;\\n" '
        '::"l"(ticket) : "memory");\n'
        "    return;\n"
        "  }\n"
        "  if (tid == 0)\n"
        "    for (;;) {\n"
        "      int c;\n"
        '      asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\\n" : "=r"(c) '
        ': "l"(ticket) : "memory");\n'
        "      if (c >= n_p - 1) break;\n"
        "      __nanosleep(32);\n"
        "    }\n"
        "  __syncthreads();\n")
MERGE_WEIGHT = "const float cj = j0 + u < jb ? exp2f(mj[u] - mb) : 0.f;"
MERGE_BATCH = "constexpr int MERGE_BATCH = 4; "
MERGE_BATCH_F32 = "constexpr int MERGE_BATCH_F32 = 2; "
DEC32 = "constexpr int DEC32_TOKENS = 64; "
F32_MERGE = "  if (n_p == 1) return;\n  last_ticket_merge<DEC32_THREADS"
F32_PV = "  for (int tt = tg; tt < nv; tt += TG) {"
F32_V_STAGE = "  stage(Vs, v, voff_s, 0);\n"


def _merge_batch(n: int, suffix: str = "") -> str:
    return f"constexpr int MERGE_BATCH{suffix} = {n}; "


# -- prefill_f32: the f32 paged prefill body ---------------------------
PF32 = ("constexpr int PF32_TOKENS = 64;", "constexpr int PF32_GROUPS = 2;")
PF32_ENTRY = ("  return launch_prefill_f32(q, k, v, bt, starts, ntoks, out, B, C, H, "
              "Hkv, D, P, n_slots,\n")
ALLOW_SMEM = "template <typename K>\nint allow_smem("
# what the replaced token-by-token f32 bodies (decode and prefill)
# shared, as it was
TOKEN_LOOP_HELPERS = r'''constexpr int WARPS = 8;                 // f32 decode: warps per block
constexpr int THREADS = WARPS * 32;
constexpr int COMBINE_THREADS = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

template <int N>
__device__ __forceinline__ void warp_sum_rows(float (&x)[N]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int n = 0; n < N; ++n) x[n] += __shfl_xor_sync(0xffffffffu, x[n], o);
  }
}

// Load one token's K and V row slice of this lane: dims lane + 32 i.
template <typename T, int NV>
__device__ __forceinline__ void load_token(const T* __restrict__ k, const T* __restrict__ v,
                                           int64_t k_off, int64_t v_off, int lane, int D,
                                           float (&kr)[NV], float (&vr)[NV]) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    int d = lane + 32 * i;
    kr[i] = d < D ? to_f32(k[k_off + d]) : 0.f;
    vr[i] = d < D ? to_f32(v[v_off + d]) : 0.f;
  }
}

// Fold one token (score s, value row vr) into a row's running state.
template <int NV>
__device__ __forceinline__ void online_token(float s, const float (&vr)[NV], float& m,
                                             float& l, float (&acc)[NV]) {
  float m_new = fmaxf(m, s);
  float alpha = expf(m - m_new);
  float p = expf(s - m_new);
  l = l * alpha + p;
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] = fmaf(p, vr[i], acc[i] * alpha);
  m = m_new;
}

'''
# the f32 prefill body this design replaced (a warp per 8 score rows,
# token by token), as it was: the before of the same call
TOKEN_LOOP_PREFILL = r'''constexpr int ROWS_PER_WARP = 8;


// ---------------------------------------------------------------------
// prefill window: grid (B, ceil(C / block_q), H_kv).  The block owns
// window rows [q0, q0 + block_q) x the group of query heads of KV head
// h: R = rows * group score rows, row r -> window row q0 + r / group,
// head h * group + r % group.  Warp w owns rows w, w + WARPS, ...  Row
// j sits at position start + j and sees the first start + j + 1 paged
// tokens; rows j >= n_tok see none and come out zero.
// ---------------------------------------------------------------------
template <typename T, int NV>
__global__ void __launch_bounds__(THREADS)
paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int32_t* __restrict__ block_tables,
                     const int32_t* __restrict__ starts, const int32_t* __restrict__ n_toks,
                     T* __restrict__ out, int C, int H, int Hkv, int D, int P, int n_slots,
                     int64_t k_page_stride, int64_t v_page_stride, float sm_scale,
                     int block_q) {
  const int b = blockIdx.x, q0 = blockIdx.y * block_q, h = blockIdx.z;
  const int group = H / Hkv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int R = min(block_q, C - q0) * group;
  const int start = starts[b], ntok = n_toks[b];

  float qr[ROWS_PER_WARP][NV], acc[ROWS_PER_WARP][NV], m[ROWS_PER_WARP],
      l[ROWS_PER_WARP];
  int lim[ROWS_PER_WARP];
  int64_t off[ROWS_PER_WARP];
  int walk = 0;                                   // tokens this warp visits
#pragma unroll
  for (int k2 = 0; k2 < ROWS_PER_WARP; ++k2) {
    const int r = warp + WARPS * k2;
    const int j = q0 + r / group, g = r % group;
    lim[k2] = (r < R && j < ntok) ? start + j + 1 : 0;
    walk = max(walk, lim[k2]);
    off[k2] = (((int64_t)b * C + j) * H + (int64_t)h * group + g) * D;
    m[k2] = NEG_INF;
    l[k2] = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      int d = lane + 32 * i;
      qr[k2][i] = (lim[k2] > 0 && d < D) ? to_f32(q[off[k2] + d]) : 0.f;
      acc[k2][i] = 0.f;
    }
  }
  const int32_t* bt = block_tables + (int64_t)b * n_slots;
  const int64_t tok_stride = (int64_t)Hkv * D;
  walk = min(walk, n_slots * P);
  // software pipeline: the next token's K/V loads are in flight while
  // this token's scores and updates run
  float kr[NV], vr[NV], kn[NV], vn[NV];
  auto fetch = [&](int tok, float (&kx)[NV], float (&vx)[NV]) {
    const int64_t page = bt[tok / P];
    const int64_t in_page = (int64_t)(tok % P) * tok_stride + (int64_t)h * D;
    load_token<T, NV>(k, v, page * k_page_stride + in_page, page * v_page_stride + in_page,
                      lane, D, kx, vx);
  };
  if (walk > 0) fetch(0, kr, vr);
  for (int tok = 0; tok < walk; ++tok) {
    if (tok + 1 < walk) fetch(tok + 1, kn, vn);
    float part[ROWS_PER_WARP];
#pragma unroll
    for (int k2 = 0; k2 < ROWS_PER_WARP; ++k2) {
      part[k2] = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) part[k2] = fmaf(qr[k2][i], kr[i], part[k2]);
    }
    warp_sum_rows<ROWS_PER_WARP>(part);
#pragma unroll
    for (int k2 = 0; k2 < ROWS_PER_WARP; ++k2) {
      if (tok < lim[k2])                          // warp-uniform
        online_token<NV>(part[k2] * sm_scale, vr, m[k2], l[k2], acc[k2]);
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      kr[i] = kn[i];
      vr[i] = vn[i];
    }
  }
#pragma unroll
  for (int k2 = 0; k2 < ROWS_PER_WARP; ++k2) {
    const int r = warp + WARPS * k2;
    if (r >= R) continue;
    const float inv = 1.f / fmaxf(l[k2], 1e-30f);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      int d = lane + 32 * i;
      if (d < D) out[off[k2] + d] = from_f32<T>(acc[k2][i] * inv);
    }
  }
}


template <typename T, int NV>
int launch_prefill_nv(const void* q, const void* k, const void* v, const void* bt,
                      const void* starts, const void* ntoks, void* out, int B, int C, int H,
                      int Hkv, int D, int P, int n_slots, long long kps, long long vps,
                      float sc, int block_q, cudaStream_t st) {
  dim3 grid(B, (C + block_q - 1) / block_q, Hkv);
  paged_prefill_kernel<T, NV><<<grid, THREADS, 0, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int32_t*)bt, (const int32_t*)starts,
      (const int32_t*)ntoks, (T*)out, C, H, Hkv, D, P, n_slots, kps, vps, sc, block_q);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_prefill_token_loop(const void* q, const void* k, const void* v, const void* bt,
                   const void* starts, const void* ntoks, void* out, int B, int C, int H,
                   int Hkv, int D, int P, int n_slots, long long kps, long long vps,
                   float sc, int block_q, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D <= 32)
    return launch_prefill_nv<T, 1>(q, k, v, bt, starts, ntoks, out, B, C, H, Hkv, D, P,
                                   n_slots, kps, vps, sc, block_q, st);
  if (D <= 64)
    return launch_prefill_nv<T, 2>(q, k, v, bt, starts, ntoks, out, B, C, H, Hkv, D, P,
                                   n_slots, kps, vps, sc, block_q, st);
  if (D <= 128)
    return launch_prefill_nv<T, 4>(q, k, v, bt, starts, ntoks, out, B, C, H, Hkv, D, P,
                                   n_slots, kps, vps, sc, block_q, st);
  return launch_prefill_nv<T, 8>(q, k, v, bt, starts, ntoks, out, B, C, H, Hkv, D, P,
                                 n_slots, kps, vps, sc, block_q, st);
}

'''
# the f32 decode this design replaced (each sequence split over S
# blocks of 8 warps, token by token, then a merge kernel), as it was, and
# an entry with the new one's arguments: S from the SM count as that
# design's wrapper chose it, at most the 64-token partitions the
# wrapper's scratch is sized for
SPLIT_DECODE = r'''// ---------------------------------------------------------------------
// decode, pass 1: grid (B, H_kv, S).  Block (b, h, split) takes the
// tokens [split * chunk, (split + 1) * chunk) of sequence b (chunk =
// ceil(length / S)) for the G query rows of KV head h; warp w takes
// every WARPS-th token of that range.  Writes the block's unnormalised
// partial (m, l, acc) per query row.
// ---------------------------------------------------------------------
template <typename T, int NV, int G>
__global__ void __launch_bounds__(THREADS)
paged_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const int32_t* __restrict__ block_tables,
                          const int32_t* __restrict__ lengths, float* __restrict__ m_part,
                          float* __restrict__ l_part, float* __restrict__ acc_part, int H,
                          int Hkv, int D, int P, int n_slots, int64_t k_page_stride,
                          int64_t v_page_stride, float sm_scale, int S) {
  extern __shared__ float smem[];                 // WARPS x group x (D + 2)
  const int b = blockIdx.x, h = blockIdx.y, split = blockIdx.z;
  const int group = H / Hkv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int length = min(lengths[b], n_slots * P);    // the table's reach
  const int chunk = (length + S - 1) / S;
  const int t0 = split * chunk, t1 = min(length, t0 + chunk);

  float qr[G][NV], acc[G][NV], m[G], l[G];
  const T* qb = q + ((int64_t)b * H + (int64_t)h * group) * D;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      int d = lane + 32 * i;
      qr[g][i] = (g < group && d < D) ? to_f32(qb[(int64_t)g * D + d]) : 0.f;
      acc[g][i] = 0.f;
    }
  }
  const int32_t* bt = block_tables + (int64_t)b * n_slots;
  const int64_t tok_stride = (int64_t)Hkv * D;
  // software pipeline: the next token's K/V loads are in flight while
  // this token's scores and updates run
  float kr[NV], vr[NV], kn[NV], vn[NV];
  auto fetch = [&](int tok, float (&kx)[NV], float (&vx)[NV]) {
    const int64_t page = bt[tok / P];
    const int64_t in_page = (int64_t)(tok % P) * tok_stride + (int64_t)h * D;
    load_token<T, NV>(k, v, page * k_page_stride + in_page, page * v_page_stride + in_page,
                      lane, D, kx, vx);
  };
  if (t0 + warp < t1) fetch(t0 + warp, kr, vr);
  for (int tok = t0 + warp; tok < t1; tok += WARPS) {
    if (tok + WARPS < t1) fetch(tok + WARPS, kn, vn);
    float part[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      part[g] = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) part[g] = fmaf(qr[g][i], kr[i], part[g]);
    }
    warp_sum_rows<G>(part);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g < group) online_token<NV>(part[g] * sm_scale, vr, m[g], l[g], acc[g]);
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      kr[i] = kn[i];
      vr[i] = vn[i];
    }
  }
  // merge the warps: per row, rescale each warp's state to the max
  const int W = D + 2;
  float* mine = smem + (size_t)warp * group * W;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g >= group) break;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      int d = lane + 32 * i;
      if (d < D) mine[g * W + d] = acc[g][i];
    }
    if (lane == 0) {
      mine[g * W + D] = m[g];
      mine[g * W + D + 1] = l[g];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < group * D; idx += blockDim.x) {
    int g = idx / D, d = idx - g * D;
    float M = NEG_INF;
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, smem[(size_t)(w * group + g) * W + D]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float* row = smem + (size_t)(w * group + g) * W;
      float c = expf(row[D] - M);
      L += row[D + 1] * c;
      A += row[d] * c;
    }
    int64_t prow = ((int64_t)b * H + (int64_t)h * group + g) * S + split;
    acc_part[prow * D + d] = A;
    if (d == 0) {
      m_part[prow] = M;
      l_part[prow] = L;
    }
  }
}

// decode, pass 2: grid (B * H); merge the S partials of one query row
// and normalise.
template <typename T>
__global__ void __launch_bounds__(COMBINE_THREADS)
paged_decode_combine_kernel(const float* __restrict__ m_part, const float* __restrict__ l_part,
                            const float* __restrict__ acc_part, T* __restrict__ out, int D,
                            int S) {
  const int64_t row = blockIdx.x;
  float M = NEG_INF;
  for (int s = 0; s < S; ++s) M = fmaxf(M, m_part[row * S + s]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float L = 0.f, A = 0.f;
    for (int s = 0; s < S; ++s) {
      float c = expf(m_part[row * S + s] - M);
      L += l_part[row * S + s] * c;
      A += acc_part[(row * S + s) * D + d] * c;
    }
    out[row * D + d] = from_f32<T>(A / fmaxf(L, 1e-30f));
  }
}

template <typename T, int NV, int G>
int launch_decode_nv_g(const void* q, const void* k, const void* v, const void* bt,
                       const void* lens, void* m_part, void* l_part, void* acc_part,
                       void* out, int B, int H, int Hkv, int D, int P, int n_slots,
                       long long kps, long long vps, float sm_scale, int S,
                       cudaStream_t stream) {
  const size_t bytes = (size_t)WARPS * (H / Hkv) * (D + 2) * sizeof(float);
  auto split = paged_decode_split_kernel<T, NV, G>;
  int err = allow_smem(split, bytes);
  if (err) return err;
  split<<<dim3(B, Hkv, S), THREADS, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int32_t*)bt, (const int32_t*)lens,
      (float*)m_part, (float*)l_part, (float*)acc_part, H, Hkv, D, P, n_slots, kps, vps,
      sm_scale, S);
  err = (int)cudaGetLastError();
  if (err) return err;
  paged_decode_combine_kernel<T><<<B * H, COMBINE_THREADS, 0, stream>>>(
      (const float*)m_part, (const float*)l_part, (const float*)acc_part, (T*)out, D, S);
  return (int)cudaGetLastError();
}

template <typename T, int NV>
int launch_decode_nv(int group, const void* q, const void* k, const void* v,
                     const void* bt, const void* lens, void* mp, void* lp, void* ap,
                     void* out, int B, int H, int Hkv, int D, int P, int n_slots,
                     long long kps, long long vps, float sc, int S, cudaStream_t st) {
  if (group <= 4)
    return launch_decode_nv_g<T, NV, 4>(q, k, v, bt, lens, mp, lp, ap, out, B, H, Hkv, D,
                                        P, n_slots, kps, vps, sc, S, st);
  return launch_decode_nv_g<T, NV, 8>(q, k, v, bt, lens, mp, lp, ap, out, B, H, Hkv, D, P,
                                      n_slots, kps, vps, sc, S, st);
}

template <typename T>
int launch_decode(const void* q, const void* k, const void* v, const void* bt,
                  const void* lens, void* mp, void* lp, void* ap, void* out, int B, int H,
                  int Hkv, int D, int P, int n_slots, long long kps, long long vps,
                  float sc, int S, void* stream) {
  const int group = H / Hkv;
  cudaStream_t st = (cudaStream_t)stream;
  if (D <= 32)
    return launch_decode_nv<T, 1>(group, q, k, v, bt, lens, mp, lp, ap, out, B, H, Hkv, D,
                                  P, n_slots, kps, vps, sc, S, st);
  if (D <= 64)
    return launch_decode_nv<T, 2>(group, q, k, v, bt, lens, mp, lp, ap, out, B, H, Hkv, D,
                                  P, n_slots, kps, vps, sc, S, st);
  if (D <= 128)
    return launch_decode_nv<T, 4>(group, q, k, v, bt, lens, mp, lp, ap, out, B, H, Hkv, D,
                                  P, n_slots, kps, vps, sc, S, st);
  return launch_decode_nv<T, 8>(group, q, k, v, bt, lens, mp, lp, ap, out, B, H, Hkv, D, P,
                                n_slots, kps, vps, sc, S, st);
}

int launch_decode_split(const void* q, const void* k, const void* v, const void* bt,
                        const void* lens, void* mp, void* lp, void* ap, void* out, int B,
                        int H, int Hkv, int D, int P, int n_slots, long long kps,
                        long long vps, float sc, void* stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int cap = (n_slots * P + 63) / 64;
  int S = (4 * sms + B * Hkv - 1) / (B * Hkv);
  S = S > 16 ? 16 : S;
  S = S > cap ? cap : S < 1 ? 1 : S;
  return launch_decode<float>(q, k, v, bt, lens, mp, lp, ap, out, B, H, Hkv, D, P, n_slots,
                              kps, vps, sc, S, stream);
}

'''
DECODE_F32_ENTRY = ("  cudaStream_t st = (cudaStream_t)stream;\n"
                    "  if (D <= 64)\n    return launch_decode_f32_g<64>(")
SPLIT_ENTRY = ("  return launch_decode_split(q, k, v, bt, lens, m_part, l_part, "
               "acc_part, out, B, H, Hkv, D,\n"
               "                             P, n_slots, k_page_stride, "
               "v_page_stride, sm_scale, stream);\n"
               + DECODE_F32_ENTRY)
DECODE_BF16_SMEM = "constexpr size_t decode_bf16_smem_bytes(int dp) {"
PF32_ORDER = ("  const int b = lin % gridDim.x, h = lin / gridDim.x % gridDim.z;\n"
              "  const int q0 = (gridDim.y - 1 - lin / (gridDim.x * gridDim.z)) "
              "* block_q;\n")
TOKEN_LOOP_ENTRY = ("  return launch_prefill_token_loop<float>(q, k, v, bt, starts, "
                    "ntoks, out, B, C, H, Hkv, D, P, n_slots,\n")

# -- combine: the elementwise combine ----------------------------------
UNROLL = "constexpr int UNROLL = 4; "
COMBINE_THREADS = "constexpr int THREADS = 128;"
COMBINE_LOADS = "          x[u] = pa[j];\n          y[u] = pb[j];\n"
COMBINE_STORE = "          po[j] = r;\n"
COMBINE_PACK = "// n_units units of VEC elements, in tiles of tile_units units"
# read-once loads (ld.global.nc.L1::no_allocate) and streaming stores
# (st.global.cs) for the 16-byte units, the design's first build
STREAM_IO = r'''template <typename P>
__device__ __forceinline__ P load_once(const P* p) {
  if constexpr (sizeof(P) == 16) {
    uint4 r;
    asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(p));
    return *reinterpret_cast<P*>(&r);
  } else {
    return *p;
  }
}

template <typename P>
__device__ __forceinline__ void store_stream(P* p, const P& x) {
  if constexpr (sizeof(P) == 16) {
    const uint4 r = *reinterpret_cast<const uint4*>(&x);
    asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(p), "r"(r.x),
                 "r"(r.y), "r"(r.z), "r"(r.w) : "memory");
  } else {
    *p = x;
  }
}

'''


def _unroll(n: int) -> str:
    return f"constexpr int UNROLL = {n}; "


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
        "merge_batch_8": ({PAGED: [(MERGE_BATCH, _merge_batch(8))]}, {}),
        "broken_merge_leaves_out_partition_0": (
            {PAGED: [(MERGE_WEIGHT, MERGE_WEIGHT.replace(
                "j0 + u < jb", "j0 + u < jb && j0 + u > 0"))]}, {}),
    },
    "decode_f32": {
        "committed": ({}, {}),
        "partition_128_tokens": (
            {PAGED: [(DEC32, "constexpr int DEC32_TOKENS = 128;")]},
            {"DECODE_TOKENS_F32": {64: 128, 128: 128, 256: 64}}),
        "merge_batch_4": (
            {PAGED: [(MERGE_BATCH_F32, _merge_batch(4, "_F32"))]}, {}),
        "merge_batch_8": (
            {PAGED: [(MERGE_BATCH_F32, _merge_batch(8, "_F32"))]}, {}),
        "broken_merge_leaves_out_partition_0": (
            {PAGED: [(MERGE_WEIGHT, MERGE_WEIGHT.replace(
                "j0 + u < jb", "j0 + u < jb && j0 + u > 0"))]}, {}),
        "diagnostic_no_merge": (
            {PAGED: [(F32_MERGE, F32_MERGE.replace("if (n_p == 1) ", ""))]},
            {}),
        "diagnostic_no_pv": (
            {PAGED: [(F32_PV, F32_PV.replace("tt < nv", "tt < 0"))]}, {}),
        "diagnostic_no_v_loads": (
            {PAGED: [(F32_V_STAGE, "  cp_async_commit();\n")]}, {}),
        "replaced_split_and_combine": (
            {PAGED: [(DECODE_BF16_SMEM, TOKEN_LOOP_HELPERS + SPLIT_DECODE
                      + DECODE_BF16_SMEM),
                     (DECODE_F32_ENTRY, SPLIT_ENTRY)]}, {}),
    },
    "prefill_f32": {
        "committed": ({}, {}),
        "one_token_group": (
            {PAGED: [(PF32[1], "constexpr int PF32_GROUPS = 1;")]},
            {"PREFILL_GROUPS_F32": 1}),
        "tiles_of_32_tokens": (
            {PAGED: [(PF32[0], "constexpr int PF32_TOKENS = 32;")]},
            {"PREFILL_TOKENS_F32": {64: 32, 128: 32, 256: 32}}),
        "four_groups_of_32_tokens": (
            {PAGED: [(PF32[0], "constexpr int PF32_TOKENS = 32;"),
                     (PF32[1], "constexpr int PF32_GROUPS = 4;")]},
            {"PREFILL_TOKENS_F32": {64: 32, 128: 32, 256: 32},
             "PREFILL_GROUPS_F32": 4}),
        "blocks_in_grid_order": (
            {PAGED: [(PF32_ORDER, "  const int b = blockIdx.x, h = blockIdx.z, "
                                  "q0 = blockIdx.y * block_q;\n")]}, {}),
        "replaced_token_loop": (
            {PAGED: [(ALLOW_SMEM,
                      TOKEN_LOOP_HELPERS + TOKEN_LOOP_PREFILL + ALLOW_SMEM),
                     (PF32_ENTRY, TOKEN_LOOP_ENTRY)]}, {}),
    },
    "combine": {
        "committed": ({}, {}),
        "unroll_2": ({COMBINE: [(UNROLL, _unroll(2))]}, {"UNROLL": 2}),
        "unroll_8": ({COMBINE: [(UNROLL, _unroll(8))]}, {"UNROLL": 8}),
        "blocks_per_sm_16": ({}, {"BLOCKS_PER_SM": 16}),
        "blocks_of_256_threads_4_per_sm": (
            {COMBINE: [(COMBINE_THREADS, "constexpr int THREADS = 256;")]},
            {"THREADS": 256, "BLOCKS_PER_SM": 4}),
        "blocks_of_256_threads_4_per_sm_unroll_8": (
            {COMBINE: [(COMBINE_THREADS, "constexpr int THREADS = 256;"),
                       (UNROLL, _unroll(8))]},
            {"THREADS": 256, "BLOCKS_PER_SM": 4, "UNROLL": 8}),
        "read_once_loads_streaming_stores": (
            {COMBINE: [(COMBINE_PACK, STREAM_IO + COMBINE_PACK),
                       (COMBINE_LOADS, "          x[u] = load_once(pa + j);\n"
                                       "          y[u] = load_once(pb + j);\n"),
                       (COMBINE_STORE, "          store_stream(po + j, r);\n")]},
            {}),
        "replaced_one_pair_a_thread_grid_by_tiles": (
            {COMBINE: [(COMBINE_THREADS, "constexpr int THREADS = 256;"),
                       (UNROLL, _unroll(1))]},
            {"THREADS": 256, "UNROLL": 1, "BLOCKS_PER_SM": 16}),
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
SOURCES = {"attention": (FLASH, PAGED), "decode": (PAGED,),
           "decode_f32": (PAGED,), "copy": (COPY,),
           "prefill_f32": (PAGED,), "combine": (COMBINE,)}


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


def decode_row(cs, pa, dev, dt, data) -> tuple:
    row, ok = {}, True
    tol = cs.DECODE_TOL[dt]
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


def decode_data(cs, pa, dev, dt, slots_256: bool) -> dict:
    """chip_smoke's decode timing shape and 8 x 4096 tokens in ``dt``,
    and with ``slots_256`` the timing shape's lengths on a table of 256
    slots (the serve path's: 4096 tokens of reach)."""
    cases = {"timing": cs.decode_case(dt, dev),
             "long": cs.decode_long_case(dt, dev)}
    if slots_256:
        cases["timing_256_slots"] = cs.decode_case(dt, dev,
                                                   n_slots=cs.LONG_SLOTS)
    return {tag: (args, pa.paged_decode_attention_ref(*args))
            for tag, args in cases.items()}


def prefill_f32_row(cs, pa, dev, data) -> tuple:
    row, ok = {}, True
    for tag, (args, ref) in data.items():
        got = pa.paged_prefill_attention(*args)
        torch.cuda.synchronize()
        row[f"{tag}_err"] = (got - ref).abs().max().item()
        ok &= row[f"{tag}_err"] <= cs.TOL[torch.float32]
        row[f"{tag}_ms"] = cs.time_ms(
            lambda: pa.paged_prefill_attention(*args), dev)
    return row, ok


def prefill_f32_data(cs, pa, dev) -> dict:
    """chip_smoke's f32 timing window, and 8 windows of 64 rows at
    positions 900-963 (every block walks 15 tiles)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    pool, bt = cs.make_pool(gen, torch.float32, dev)
    q = torch.randn((cs.B, cs.WINDOW, cs.H, cs.D), generator=gen, device=dev)
    full = torch.full((cs.B,), cs.WINDOW, dtype=torch.int32, device=dev)
    cases = {"timing": cs.prefill_case(torch.float32, dev),
             "long": (q, pool[:, 0, 1], pool[:, 1, 1], bt, full * 0 + 900,
                      full)}
    return {tag: (args, pa.paged_prefill_attention_ref(*args))
            for tag, args in cases.items()}


def combine_row(cs, rc, dev, xs) -> tuple:
    row, ok = {}, True
    x, y = xs
    for variant in (rc.DEFAULT_VARIANT, "vmem_8x128", "vmem_256x256"):
        got = rc.combine_blocked(x, y, "sum", variant)
        torch.cuda.synchronize()
        same = torch.equal(got.view(torch.int32),
                           torch.add(x, y).view(torch.int32))
        row[f"{variant}_bit_exact"] = same
        ok &= same
        row[f"{variant}_ms"] = cs.time_ms(
            lambda: rc.combine_blocked(x, y, "sum", variant), dev)
        row[f"{variant}_add_ms"] = cs.time_ms(lambda: torch.add(x, y), dev)
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
    from repro_torch.kernels import reduce_combine as rc
    from repro_torch.kernels import symm_copy as sc

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card, flush=True)
    csrc = build.CSRC
    saved = {"bf16_tiles": fa.TILES[torch.bfloat16],
             "DECODE_TOKENS": pa.DECODE_TOKENS,
             "DECODE_TOKENS_F32": pa.DECODE_TOKENS_F32,
             "STAGE_BYTES": sc.STAGE_BYTES,
             "PREFILL_TOKENS_F32": pa.PREFILL_TOKENS_F32,
             "PREFILL_GROUPS_F32": pa.PREFILL_GROUPS_F32,
             "UNROLL": rc.UNROLL, "BLOCKS_PER_SM": rc.BLOCKS_PER_SM,
             "THREADS": rc.THREADS}

    def settle(settings: dict) -> None:
        s = {**saved, **settings}
        fa.TILES[torch.bfloat16] = s["bf16_tiles"]
        pa.DECODE_TOKENS = s["DECODE_TOKENS"]
        pa.DECODE_TOKENS_F32 = s["DECODE_TOKENS_F32"]
        sc.STAGE_BYTES = s["STAGE_BYTES"]
        pa.PREFILL_TOKENS_F32 = s["PREFILL_TOKENS_F32"]
        pa.PREFILL_GROUPS_F32 = s["PREFILL_GROUPS_F32"]
        rc.UNROLL, rc.BLOCKS_PER_SM = s["UNROLL"], s["BLOCKS_PER_SM"]
        rc.THREADS = s["THREADS"]
        build._LOADED.clear()
        sc._FNS.clear()
        rc._FNS.clear()

    rows, status = [], 0
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
        elif group in ("decode", "decode_f32"):
            dt = torch.float32 if group == "decode_f32" else torch.bfloat16
            data = decode_data(cs, pa, dev, dt, group == "decode_f32")
            measure = partial(decode_row, cs, pa, dev, dt, data)
        elif group == "prefill_f32":
            data = prefill_f32_data(cs, pa, dev)
            measure = partial(prefill_f32_row, cs, pa, dev, data)
        elif group == "combine":
            data = [torch.randn(cs.STAGED, device=dev) for _ in range(2)]
            measure = partial(combine_row, cs, rc, dev, data)
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
                    status = 1
                else:
                    got, ok = measure()
                    row.update(got, checks_pass=ok)
                    if name == "committed" and not ok:
                        status = 1
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
    return status


if __name__ == "__main__":
    sys.exit(main())
