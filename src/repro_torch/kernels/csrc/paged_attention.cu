// Paged attention through a block table, hand-written for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/paged_attention.py:
//   paged_decode_attention   (body _paged_kernel)   -> paged_decode_bf16_kernel (bf16)
//                                                      paged_decode_f32_kernel (f32)
//   paged_prefill_attention  (body _prefill_kernel) -> paged_prefill_mma_kernel (bf16)
//                                                      paged_prefill_f32_kernel (f32)
// The wrapper picks the body by dtype, a fixed dispatch.  Both dtypes
// serve: bf16 is the port's default, f32 the reference's only serving
// dtype (src/repro/launch/serve.py builds every engine in f32) and
// `python -m repro_torch.launch.serve --dtype f32`.
//
// Semantics are the reference's to the constant: scores scaled by
// sm_scale, a softmax in f32, NEG_INF = -1e30 as the empty max, masked
// (out-of-range) tokens contributing exactly zero — the re-masked p = 0
// of the reference — and the output divided by max(l, 1e-30).  A decode
// row of length 0 and a window row j >= n_tok come out as exact zeros;
// a length past the table's reach n_slots * P is clamped to it.
//
// What bounds them on an H100: bytes.  Decode reads each K/V token of
// a (sequence, KV head) once and does 4 flops per element (~2 per byte
// in bf16), far under the ~295 flops per byte where the tensor cores
// would become the limit.  Common to all bodies: the per-layer K/V is
// read IN PLACE as a strided view of the whole (n_pages, 2, L, P, H_kv,
// D) pool (the page stride is an argument), page ids are read by the
// kernel itself (no scalar prefetch), and the walk stops at the last
// valid token (the TPU grid visits every one of the n_slots table slots).
//
// Decode, one launch per step in both dtypes, one structure:
//   * fixed token partitions: a block of 8 warps owns T tokens of one
//     (sequence, KV head), all G query heads of that KV head; the grid is
//     (H_kv, B, n_slots * P / T), from the table and never from the
//     lengths (the host reads no length), partition major, and a block
//     past its sequence's length exits at once;
//   * it reads its page ids beside the length, then puts all of its K
//     and V rows in flight at once as 16-byte cp.async copies into
//     shared memory, XOR-swizzled where the reads would conflict (any page
//     size; tokens past the length zero-filled), so a block pays one
//     memory latency, not one per token;
//   * one max and one sum per head over the partition, one exp per
//     (token, head), no running rescale;
//   * a sequence of one partition writes its output directly; otherwise
//     every block writes its partial and takes a ticket of its (sequence,
//     KV head) by an acq_rel atomic add; the block that draws the last
//     ticket, whichever partition it holds, merges the partials in
//     partition order, never in arrival order (so every call gives the
//     same bits), and resets the ticket (last_ticket_merge, shared by both
//     bodies).  No block waits for another, so nothing rests on the order
//     in which the hardware dispatches blocks.
// bf16 (paged_decode_bf16_kernel), T = DEC_TOKENS = 128: S^T = K Q^T and
// O^T = V^T P^T run as mma.sync m16n8k16 (bf16 in, f32 accumulate) with
// the tokens, then the head dims, as M and the <= 8 query heads as N.
// Measured against the 64-token partition of 4 warps, other merge
// batches and a merge by the last partition's block spinning on the
// count by scripts/kernel_variants.py: the 128-token partition halves the
// partials, the tickets and the merge's loads at long contexts (PERF.md).
// f32 (paged_decode_f32_kernel), T = DEC32_TOKENS = 64, on the CUDA cores
// (TF32 stays off: the reference computes in f32): a thread per (token,
// quarter of the head dim) takes the scores of all G heads from one K
// load per 16-byte chunk, q broadcast; a warp per head takes the softmax;
// a thread per (4-dim column, token group) takes P V for all G heads from
// one V load.  64 KB of K/V stages at D = 128, so three blocks share an
// SM; 64- against 128-token partitions and the merge batch were measured
// by scripts/kernel_variants.py (PERF.md).

// The prefill window in bf16 (the port's default dtype) is a tile design
// on the tensor cores, so that each K/V byte is moved once per block and
// the products stay off the critical path:
//   * a block owns one (sequence, KV head) and up to 64 score rows —
//     window rows x the query heads of its KV head (16 x 4 at qwen3-8b),
//     four 16-row mma tiles, one per warp;
//   * it walks the context in tiles of 64 tokens, gathered through the
//     block table (page ids read by the kernel, the per-layer pool view
//     read in place through the page strides, a page size that does not
//     divide the tile handled token by token) with 16-byte cp.async
//     copies into a two-stage ring of XOR-swizzled shared-memory tiles,
//     and stops at the last token any of its rows can see;
//   * S = Q K^T and O += P V run as mma.sync m16n8k16 (bf16 in, f32
//     accumulate) fed by ldmatrix; the online softmax runs on the
//     fragments, each row masked at its own causal limit start + j + 1,
//     and P stays in registers as the A operand of P V.
// At chip_smoke's timing shape (8 sequences, 64-row windows, contexts to
// 512, bf16) it takes 0.044 ms on an NVIDIA H100 80GB HBM3 at 700 W, 9%
// of its byte bound: what holds it now is the latency of the dependent
// chain of tiles per block, not bytes (PERF.md).
//
// The prefill window in f32 (paged_prefill_f32_kernel) is the same tile
// walk on the CUDA cores: TF32 stays off, the reference computes in f32.
// An f32 window is bound by operations (4 flops per visible (row, token,
// dim) against 67 TFLOP/s; ~1.5x its byte time at the timing shape), so
// what matters is FMAs per shared-memory load and the length of the
// chain a block walks:
//   * the grid and rows are the bf16 body's (choose_block): a block owns
//     one (sequence, KV head) and up to 64 score rows; Q is staged once;
//     the last q block of every (sequence, KV head), whose rows see the
//     most context, is dispatched first;
//   * PF32_GROUPS token groups of 128 threads split the context: group g
//     walks tiles g, g + 2, ... of PF32_TOKENS (32 at D = 256) tokens
//     with its own (m, l, acc), so a long context is two chains, not one;
//     group 0 merges the others' state at the end;
//   * each group gathers its tiles through the block table (page ids read
//     by the kernel, the pool view read in place, any page size) by
//     16-byte cp.async into its own two-buffer ring, K tile kt landing
//     while P V of the group's previous tile runs and V tile kt while the
//     scores of tile kt run, and stops at the last token its rows see;
//   * S = Q K^T and O += P V are per-thread register tiles (8 rows x 4
//     columns of scores, 8 rows x 4 NV dims of output; the flash f32
//     body's layout): 12 shared loads per 128 FMAs for the scores, 6 for
//     P V; the online softmax runs once per row per tile, each row masked
//     at its own causal limit, p re-masked to 0;
//   * 203,776 B of dynamic shared memory at D = 128 (217,088 at 256): one
//     block of 8 warps per SM.
// Its q and page rows must start and step 16-byte aligned, as for bf16.

// C interface for ctypes: every function returns cudaGetLastError() of
// its launches as an int (0 = success).

#include "hopper_util.cuh"

namespace {

using namespace hopper;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int PF_ROWS = 64;              // prefill: score rows per block (both bodies)
constexpr int PF32_TOKENS = 64;          // f32 prefill: context tokens per tile (D <= 128)
constexpr int PF32_TOKENS_D256 = 32;     // ... at D > 128, so two groups fit 227 KB
constexpr int PF32_GROUPS = 2;           // f32 prefill: token groups per block
constexpr int PF32_GROUP_THREADS = 128;  // a group: 8 row groups x 16 column threads
constexpr int PF32_PAD = 4;              // floats of padding per shared row
constexpr int PF32_LDP = PF_ROWS + PF32_PAD;  // P is stored column-major
constexpr int PF_TOKENS = 64;            // bf16 prefill: context tokens per tile
constexpr int PF_THREADS = 128;          // 4 warps x 16 rows
constexpr int VEC_BYTES = 16;
constexpr int DEC_TOKENS = 128;          // bf16 decode: tokens per partition
constexpr int DEC_WARPS = DEC_TOKENS / 16;  // a 16-token score tile per warp
constexpr int DEC_THREADS = DEC_WARPS * 32;
constexpr int TOKEN_GROUPS = DEC_WARPS / 4;  // P V: 4 warps (head-dim quarters) per group
constexpr int KT_PV = DEC_TOKENS / 16 / TOKEN_GROUPS;  // P V k-steps per warp
constexpr int DEC_ROWS = 8;              // the mma's N: query heads of a KV head
constexpr int PS_STRIDE = DEC_TOKENS + 8;  // P row stride: conflict-free B loads
constexpr int MERGE_BATCH = 4;           // bf16 decode: partitions a merging thread loads at once
constexpr int DEC_BLOCKS_PER_SM = 3;     // what 64 KB of K/V stages (D = 128) allow
constexpr int DEC32_TOKENS = 64;         // f32 decode: tokens per partition (64 at D > 128)
constexpr int DEC32_THREADS = 256;       // f32 decode: 8 warps
constexpr int MERGE_BATCH_F32 = 2;       // f32 decode: partitions a merging thread loads at once
static_assert(PF_ROWS == 8 * PF32_GROUP_THREADS / 16, "f32 prefill: 8 rows per row group");
static_assert(TOKEN_GROUPS == 1 || TOKEN_GROUPS == 2, "64 or 128 tokens per partition");
static_assert(DEC_THREADS >= DEC_TOKENS, "a thread per token computes its offsets");

// The old value of *p, after adding v (acquire and release, GPU scope).
__device__ __forceinline__ int atom_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// Max / sum over the 32 lanes of a warp.
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Four outputs a * inv to 16-byte (f32) or 8-byte (bf16, rounded) aligned p.
__device__ __forceinline__ void store4(float* p, float4 a, float inv) {
  *reinterpret_cast<float4*>(p) = make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 a, float inv) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack_bf16x2(a.x * inv, a.y * inv), pack_bf16x2(a.z * inv, a.w * inv));
}

// ---------------------------------------------------------------------
// decode, both bodies: the last-ticket merge of a (sequence, KV head).
// Every block of it has written its partial (m in base 2, l, acc) to
// rows base + part * group + head of m_part / l_part (x D of acc_part);
// n_p > 1 blocks work on it.  After the block's barrier thread 0 adds
// one to the ticket (release: the block's partial is visible first;
// acquire: so are those of the blocks counted before it).  The block that
// draws n_p - 1 arrived last and merges; the others end.  The merge writes
// the normalised output of the group's heads to ob and resets the ticket.
// `slot` is shared memory for BLOCK_THREADS x 6 floats, free by now;
// BATCH partitions' loads of a merging thread are in flight together.
// ---------------------------------------------------------------------
template <int BLOCK_THREADS, int BATCH, typename OutT>
__device__ __forceinline__ void last_ticket_merge(const float* __restrict__ m_part,
                                                  const float* __restrict__ l_part,
                                                  const float* __restrict__ acc_part,
                                                  int* __restrict__ ticket, int64_t base,
                                                  int n_p, int group, int D,
                                                  OutT* __restrict__ ob, float* slot) {
  const int tid = threadIdx.x;
  __shared__ int last_s;
  __syncthreads();
  if (tid == 0) last_s = atom_add_acq_rel(ticket, 1) == n_p - 1;
  __syncthreads();
  if (!last_s) return;
  // merge the n_p partials.  Thread t takes 4-dim column t % C' (C' = the
  // C columns, at most BLOCK_THREADS) over the r = t / C' -th of Q =
  // BLOCK_THREADS / C' contiguous ranges of partitions, in partition
  // order, BATCH partitions' m, l and acc loads in flight together, its
  // running (M, L, A) rescaled when a batch raises M; the Q ranges are
  // then combined in order through shared memory.  The same bits on every
  // call.
  const int C = group * D / 4, Cp = min(C, BLOCK_THREADS), Q = BLOCK_THREADS / Cp;
  const int rg = tid / Cp, col = tid % Cp;   // range, column
  if (rg < Q) {
    const int ja = rg * n_p / Q, jb = (rg + 1) * n_p / Q;
    for (int cc = col; cc < C; cc += Cp) {
      const int i = cc * 4, row = i / D;
      const float* mp = m_part + base + row;     // partition j: mp[j * group]
      const float* lp = l_part + base + row;
      const float* ap = acc_part + (base + row) * D + (i - row * D);   // ap[j * group * D]
      float M = NEG_INF, L = 0.f;
      float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int j0 = ja; j0 < jb; j0 += BATCH) {
        float mj[BATCH], lj[BATCH];
        float4 aj[BATCH];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          const int j = min(j0 + u, jb - 1);     // past the range: weight 0 below
          mj[u] = __ldcg(mp + j * group);
          lj[u] = __ldcg(lp + j * group);
          aj[u] = __ldcg(reinterpret_cast<const float4*>(ap + (int64_t)j * group * D));
        }
        float mb = M;
#pragma unroll
        for (int u = 0; u < BATCH; ++u) mb = fmaxf(mb, mj[u]);
        const float r = exp2f(M - mb);           // 0 on the first batch
        L *= r;
        A.x *= r;
        A.y *= r;
        A.z *= r;
        A.w *= r;
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          const float cj = j0 + u < jb ? exp2f(mj[u] - mb) : 0.f;
          L = fmaf(cj, lj[u], L);
          A.x = fmaf(cj, aj[u].x, A.x);
          A.y = fmaf(cj, aj[u].y, A.y);
          A.z = fmaf(cj, aj[u].z, A.z);
          A.w = fmaf(cj, aj[u].w, A.w);
        }
        M = mb;
      }
      if (Q == 1) {
        store4(ob + i, A, 1.f / fmaxf(L, 1e-30f));
      } else {                                   // C = Cp: one column per thread
        float* sl = slot + (rg * Cp + col) * 6;
        sl[0] = M;
        sl[1] = L;
        sl[2] = A.x;
        sl[3] = A.y;
        sl[4] = A.z;
        sl[5] = A.w;
      }
    }
  }
  if (Q > 1) {
    __syncthreads();
    if (rg == 0) {
      float M = NEG_INF;
      for (int r = 0; r < Q; ++r) M = fmaxf(M, slot[(r * Cp + col) * 6]);
      float L = 0.f;
      float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int r = 0; r < Q; ++r) {              // an empty range: M = NEG_INF, weight 0
        const float* sl = slot + (r * Cp + col) * 6;
        const float c = exp2f(sl[0] - M);
        L = fmaf(c, sl[1], L);
        A.x = fmaf(c, sl[2], A.x);
        A.y = fmaf(c, sl[3], A.y);
        A.z = fmaf(c, sl[4], A.z);
        A.w = fmaf(c, sl[5], A.w);
      }
      store4(ob + col * 4, A, 1.f / fmaxf(L, 1e-30f));
    }
  }
  if (tid == 0) *ticket = 0;             // ready for the next call
}

// ---------------------------------------------------------------------
// decode, bf16: grid (H_kv, B, n_parts), DEC_THREADS threads; partition
// major, so every sequence's first partitions are in the first wave.
// Block (h, b, part) takes tokens [part * DEC_TOKENS, (part + 1) *
// DEC_TOKENS) of sequence b for the G query heads of KV head h; the grid
// comes from the table (n_parts = ceil(n_slots * P / DEC_TOKENS)), and a
// block past its sequence's n_p = ceil(length / DEC_TOKENS) partitions
// exits at once.  Both products run as mma.sync m16n8k16 with the tokens (and
// then the head dims) as M and the G <= 8 query heads as N:
//   S^T = K Q^T   warp w: tokens 16 w .. 16 w + 15, all head dims;
//   O^T = V^T P^T warp w: head dims w DP / 4 .. (w + 1) DP / 4 - 1, all
//                 the partition's tokens, P from shared memory.
// A sequence of one partition writes its normalised output; otherwise
// each block writes its partial (m, l, acc) and takes a ticket of the
// (sequence, KV head); the block that draws the last one merges the
// partials in partition order and resets the ticket.
// ---------------------------------------------------------------------
template <int DP>
__global__ void __launch_bounds__(DEC_THREADS, DEC_BLOCKS_PER_SM)
paged_decode_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const int32_t* __restrict__ block_tables,
                         const int32_t* __restrict__ lengths, float* __restrict__ m_part,
                         float* __restrict__ l_part, float* __restrict__ acc_part,
                         int* __restrict__ tickets, __nv_bfloat16* __restrict__ out, int H,
                         int Hkv, int D, int P, int n_slots, int64_t k_page_stride,
                         int64_t v_page_stride, float sm_scale) {
  using bf16 = __nv_bfloat16;
  constexpr int VEC = VEC_BYTES / sizeof(bf16);
  constexpr int CH = DP / VEC;           // 16-byte chunks per row
  constexpr int KSTEPS = DP / 16;        // k-steps of S^T = K Q^T
  constexpr int MT = DP / 64;            // 16-dim m-tiles of O^T per warp
  extern __shared__ float4 smem4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem4);     // DEC_TOKENS x DP, swizzled
  bf16* Vs = Ks + DEC_TOKENS * DP;
  __shared__ __align__(16) bf16 Ps[DEC_ROWS * PS_STRIDE];   // P: heads x tokens
  __shared__ int64_t koff_s[DEC_TOKENS], voff_s[DEC_TOKENS];  // -1: masked
  __shared__ float red_m[DEC_WARPS][DEC_ROWS], red_l[DEC_WARPS][DEC_ROWS];

  const int h = blockIdx.x, b = blockIdx.y, part = blockIdx.z;
  const int n_parts = gridDim.z;
  const int group = H / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int reach = n_slots * P;
  const int t0 = part * DEC_TOKENS;
  // the partition's page ids are read beside the length: one latency
  int page = 0;
  if (tid < DEC_TOKENS && t0 + tid < reach)
    page = block_tables[(int64_t)b * n_slots + (t0 + tid) / P];
  const int length = min(lengths[b], reach);     // the table's reach
  const int n_p = max(0, (length + DEC_TOKENS - 1) / DEC_TOKENS);
  bf16* ob = out + ((int64_t)b * H + (int64_t)h * group) * D;
  if (part >= n_p) {
    if (n_p == 0 && part == 0)                   // length 0: exact zeros
      for (int i = tid; i < group * D; i += DEC_THREADS) ob[i] = __float2bfloat16(0.f);
    return;
  }
  if (tid < DEC_TOKENS) {
    const int t = t0 + tid;
    const int64_t in_page = (int64_t)(t % P) * Hkv * D + (int64_t)h * D;
    koff_s[tid] = t < length ? page * k_page_stride + in_page : -1;
    voff_s[tid] = t < length ? page * v_page_stride + in_page : -1;
  }
  // q as the B operand: b0 = q[g][16 kk + 2 tig, +1], b1 = the same + 8
  // (heads past the group and dims past D are zero)
  uint32_t qb[KSTEPS][2];
  const bf16* qrow = q + ((int64_t)b * H + (int64_t)h * group + g) * D;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int d = kk * 16 + 2 * tig;
    qb[kk][0] = g < group && d < D ? *reinterpret_cast<const uint32_t*>(qrow + d) : 0u;
    qb[kk][1] = g < group && d + 8 < D ? *reinterpret_cast<const uint32_t*>(qrow + d + 8) : 0u;
  }
  __syncthreads();
  // every K and V copy of the partition in flight before the first score;
  // tokens past the length and dims past D are zero-filled
  auto stage = [&](bf16* dst, const bf16* src, const int64_t* off) {
#pragma unroll
    for (int i = tid; i < DEC_TOKENS * CH; i += DEC_THREADS) {
      const int r = i / CH, c = i % CH, d = c * VEC;
      const int64_t o = off[r];
      const bool ok = o >= 0 && d < D;
      cp_async16(dst + swz<DP>(r, c), ok ? src + o + d : src, ok ? VEC_BYTES : 0);
    }
    cp_async_commit();
  };
  stage(Ks, k, koff_s);
  stage(Vs, v, voff_s);
  cp_async_wait<1>();                    // K has landed
  __syncthreads();

  // S^T: rows = tokens 16 w + g (s[0], s[1]) and + 8 (s[2], s[3]); cols =
  // heads 2 tig, 2 tig + 1
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, Ks + swz<DP>(warp * 16 + (lane & 15), kk * 2 + (lane >> 4)));
    mma_bf16_16816(s, a, qb[kk][0], qb[kk][1]);
  }
  // one max and one sum per head over the partition, base 2; p re-masked
  const float scale2 = sm_scale * LOG2E;
  const bool va = t0 + warp * 16 + g < length, vb = t0 + warp * 16 + g + 8 < length;
  s[0] = va ? s[0] * scale2 : NEG_INF;
  s[1] = va ? s[1] * scale2 : NEG_INF;
  s[2] = vb ? s[2] * scale2 : NEG_INF;
  s[3] = vb ? s[3] * scale2 : NEG_INF;
  float mx0 = fmaxf(s[0], s[2]), mx1 = fmaxf(s[1], s[3]);
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
  }
  if (g == 0) {
    red_m[warp][2 * tig] = mx0;
    red_m[warp][2 * tig + 1] = mx1;
  }
  __syncthreads();
  float m0 = NEG_INF, m1 = NEG_INF;              // finite: token t0 is valid
#pragma unroll
  for (int w = 0; w < DEC_WARPS; ++w) {
    m0 = fmaxf(m0, red_m[w][2 * tig]);
    m1 = fmaxf(m1, red_m[w][2 * tig + 1]);
  }
  const float p0 = va ? exp2f(s[0] - m0) : 0.f, p1 = va ? exp2f(s[1] - m1) : 0.f;
  const float p2 = vb ? exp2f(s[2] - m0) : 0.f, p3 = vb ? exp2f(s[3] - m1) : 0.f;
  float ls0 = p0 + p2, ls1 = p1 + p3;
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    ls0 += __shfl_xor_sync(0xffffffffu, ls0, o);
    ls1 += __shfl_xor_sync(0xffffffffu, ls1, o);
  }
  if (g == 0) {
    red_l[warp][2 * tig] = ls0;
    red_l[warp][2 * tig + 1] = ls1;
  }
  {
    bf16* pr = Ps + 2 * tig * PS_STRIDE + warp * 16 + g;
    pr[0] = __float2bfloat16(p0);
    pr[PS_STRIDE] = __float2bfloat16(p1);
    pr[8] = __float2bfloat16(p2);
    pr[PS_STRIDE + 8] = __float2bfloat16(p3);
  }
  cp_async_wait<0>();                    // V has landed
  __syncthreads();
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int w = 0; w < DEC_WARPS; ++w) {
    l0 += red_l[w][2 * tig];
    l1 += red_l[w][2 * tig + 1];
  }

  // O^T: rows = head dims dw + 16 mt + g (o[mt][0..1]) and + 8 (o[mt][2..3]);
  // cols = heads 2 tig, 2 tig + 1.  Warp w takes the head dims of quarter
  // w % 4 over token group w / 4; with two token groups the second
  // group's sums are added to the first's through shared memory (the K
  // stage, free now), in that order
  const int tg = warp / 4;
  uint32_t pb[KT_PV][2];
#pragma unroll
  for (int kt = 0; kt < KT_PV; ++kt) {
    const bf16* pr = Ps + g * PS_STRIDE + (tg * KT_PV + kt) * 16 + 2 * tig;
    pb[kt][0] = *reinterpret_cast<const uint32_t*>(pr);
    pb[kt][1] = *reinterpret_cast<const uint32_t*>(pr + 8);
  }
  const int dw = (warp % 4) * (DP / 4);
  float o[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    o[mt][0] = o[mt][1] = o[mt][2] = o[mt][3] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT_PV; ++kt) {
      uint32_t a[4];
      ldmatrix_x4_trans(a, Vs + swz<DP>((tg * KT_PV + kt) * 16 + (lane & 7) + ((lane >> 4) << 3),
                                        (dw + mt * 16) / VEC + ((lane >> 3) & 1)));
      mma_bf16_16816(o[mt], a, pb[kt][0], pb[kt][1]);
    }
  }
  if (TOKEN_GROUPS == 2) {
    float* half = reinterpret_cast<float*>(smem4) + ((warp % 4) * 32 + lane) * MT * 4;
    if (tg == 1) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) half[mt * 4 + e] = o[mt][e];
    }
    __syncthreads();
    if (tg == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[mt][e] += half[mt * 4 + e];
    }
  }

  if (n_p == 1) {                        // the whole sequence: normalise
    const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = dw + mt * 16 + g + (e >> 1) * 8, row = 2 * tig + (e & 1);
        if (tg == 0 && row < group && d < D)
          ob[row * D + d] = __float2bfloat16(o[mt][e] * ((e & 1) ? inv1 : inv0));
      }
    }
    return;
  }
  // the partial of (b, h, part): rows (b, h, part, head) of m/l, x D of acc
  const int64_t bh = (int64_t)b * Hkv + h;
  const int64_t prow = (bh * n_parts + part) * group;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = dw + mt * 16 + g + (e >> 1) * 8, row = 2 * tig + (e & 1);
      if (tg == 0 && row < group && d < D) acc_part[(prow + row) * D + d] = o[mt][e];
    }
  }
  if (warp == 0 && g == 0) {
    if (2 * tig < group) {
      m_part[prow + 2 * tig] = m0;
      l_part[prow + 2 * tig] = l0;
    }
    if (2 * tig + 1 < group) {
      m_part[prow + 2 * tig + 1] = m1;
      l_part[prow + 2 * tig + 1] = l1;
    }
  }
  last_ticket_merge<DEC_THREADS, MERGE_BATCH>(m_part, l_part, acc_part, tickets + bh,
                                              bh * n_parts * group, n_p, group, D, ob,
                                              reinterpret_cast<float*>(smem4));
}

// ---------------------------------------------------------------------
// decode, f32, CUDA cores: grid (H_kv, B, n_parts), DEC32_THREADS
// threads, partition major, as the bf16 body.  Block (h, b, part) takes
// tokens [part * T, (part + 1) * T) of sequence b for the G <= GP query
// heads of KV head h (GP: the group padded to 4 or 8); the grid comes
// from the table (n_parts = ceil(n_slots * P / T)) and a block past its
// sequence's n_p = ceil(length / T) partitions exits at once.  DP: the
// head dim padded to 64 / 128 / 256 (zeros past D in shared memory).
//   scores  thread (token t, slice s) of S = DEC32_THREADS / T slices:
//           q_g . k_t over the slice's 16-byte chunks for all GP heads,
//           K rows read from XOR-swizzled chunks (conflict-free), q
//           broadcast; the S slices' sums meet in shared memory;
//   softmax warp g: head g over the partition, one max and one sum, one
//           exp2 per (token, head), p re-masked to 0;
//   P V     thread (4-dim column c, token group tg) of TG = DEC32_THREADS
//           / (DP / 4) groups: tokens tg, tg + TG, ... below the length,
//           all GP heads from one V load; the groups' sums are added in
//           group order through shared memory.
// Then as the bf16 body: one partition writes its output, more write
// their partials and meet at the last-ticket merge.
// ---------------------------------------------------------------------
constexpr int dec32_tokens(int dp) { return dp >= 256 ? 64 : DEC32_TOKENS; }

// K and V stages of a partition, then q of DEC_ROWS heads
constexpr size_t decode_f32_smem_bytes(int dp) {
  return ((size_t)2 * dec32_tokens(dp) * dp + (size_t)DEC_ROWS * dp) * sizeof(float);
}

// the blocks per SM the registers are budgeted for: three where a
// partition's K and V stages take at most 64 KB
constexpr int dec32_blocks_per_sm(int dp) { return dec32_tokens(dp) * dp <= 64 * 128 ? 3 : 1; }

template <int DP, int T, int GP>
__global__ void __launch_bounds__(DEC32_THREADS, dec32_blocks_per_sm(DP))
paged_decode_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const int32_t* __restrict__ block_tables,
                        const int32_t* __restrict__ lengths, float* __restrict__ m_part,
                        float* __restrict__ l_part, float* __restrict__ acc_part,
                        int* __restrict__ tickets, float* __restrict__ out, int H, int Hkv,
                        int D, int P, int n_slots, int64_t k_page_stride,
                        int64_t v_page_stride, float sm_scale) {
  constexpr int CH = DP / 4;                     // 16-byte chunks per row
  constexpr int S = DEC32_THREADS / T;           // score slices of the head dim
  constexpr int CS = CH / S;                     // chunks per slice
  constexpr int TG = DEC32_THREADS / CH;         // P V token groups
  static_assert(T % 32 == 0 && DEC32_THREADS % T == 0 && CS >= 1, "slices of whole warps");
  static_assert(GP % 4 == 0 && GP <= DEC_ROWS && GP <= DEC32_THREADS / 32, "a warp per head");
  static_assert((DEC32_THREADS + T) * GP <= T * DP, "scores and P fit the K stage");
  static_assert(TG * GP * DP <= 2 * T * DP, "the token groups' sums fit both stages");
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);   // T x DP, chunk c of row r at c ^ (r % 8)
  float* Vs = Ks + T * DP;                       // T x DP
  float* Qs = Vs + T * DP;                       // DEC_ROWS x DP
  float* Sp = Ks;                                // after the scores: S x GP x T sums,
  float* Ps = Ks + DEC32_THREADS * GP;           // then P: T x GP
  float4* R = smem4;                             // after P V: TG x GP x CH sums
  __shared__ int64_t koff_s[T], voff_s[T];       // -1: masked
  __shared__ float red_l[GP];

  const int h = blockIdx.x, b = blockIdx.y, part = blockIdx.z;
  const int n_parts = gridDim.z;
  const int group = H / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int reach = n_slots * P;
  const int t0 = part * T;
  // the partition's page ids are read beside the length: one latency
  int page = 0;
  if (tid < T && t0 + tid < reach)
    page = block_tables[(int64_t)b * n_slots + (t0 + tid) / P];
  const int length = min(lengths[b], reach);     // the table's reach
  const int n_p = max(0, (length + T - 1) / T);
  float* ob = out + ((int64_t)b * H + (int64_t)h * group) * D;
  if (part >= n_p) {
    if (n_p == 0 && part == 0)                   // length 0: exact zeros
      for (int i = tid; i < group * D; i += DEC32_THREADS) ob[i] = 0.f;
    return;
  }
  const int nv = min(T, length - t0);            // the partition's valid tokens
  if (tid < T) {
    const int64_t in_page = (int64_t)((t0 + tid) % P) * Hkv * D + (int64_t)h * D;
    koff_s[tid] = tid < nv ? page * k_page_stride + in_page : -1;
    voff_s[tid] = tid < nv ? page * v_page_stride + in_page : -1;
  }
  __syncthreads();
  // q, then every K and V copy of the partition in flight before the
  // first score; heads past the group, tokens past the length and dims
  // past D are zero-filled
  const float* qg = q + ((int64_t)b * H + (int64_t)h * group) * D;
  for (int i = tid; i < GP * CH; i += DEC32_THREADS) {
    const int g = i / CH, d = (i % CH) * 4;
    const bool ok = g < group && d < D;
    cp_async16(Qs + g * DP + d, ok ? qg + g * D + d : qg, ok ? VEC_BYTES : 0);
  }
  auto stage = [&](float* dst, const float* src, const int64_t* off, int swizzle) {
#pragma unroll 4
    for (int i = tid; i < T * CH; i += DEC32_THREADS) {
      const int r = i / CH, c = i % CH, d = c * 4;
      const int64_t o = off[r];
      const bool ok = o >= 0 && d < D;
      cp_async16(dst + r * DP + ((c ^ (r & swizzle)) << 2), ok ? src + o + d : src,
                 ok ? VEC_BYTES : 0);
    }
    cp_async_commit();
  };
  stage(Ks, k, koff_s, 7);               // with q
  stage(Vs, v, voff_s, 0);
  cp_async_wait<1>();                    // q and K have landed
  __syncthreads();

  // scores of token t over slice s: 8 lanes of a load phase hold 8
  // consecutive tokens, so the swizzle puts their chunks in 8 bank groups
  const int t = tid % T, s = tid / T;
  float sc[GP];
#pragma unroll
  for (int g = 0; g < GP; ++g) sc[g] = 0.f;
  {
    const float* krow = Ks + t * DP;
#pragma unroll 4
    for (int cc = 0; cc < CS; ++cc) {
      const int c = s * CS + cc;
      const float4 kv = *reinterpret_cast<const float4*>(krow + ((c ^ (t & 7)) << 2));
#pragma unroll
      for (int g = 0; g < GP; ++g)
        sc[g] = dot4(*reinterpret_cast<const float4*>(Qs + g * DP + c * 4), kv, sc[g]);
    }
  }
  __syncthreads();                       // K read: its stage takes the scores
#pragma unroll
  for (int g = 0; g < GP; ++g) Sp[(s * GP + g) * T + t] = sc[g];
  __syncthreads();

  // one max and one sum per head over the partition, base 2; p re-masked
  const int64_t bh = (int64_t)b * Hkv + h;
  const int64_t prow = (bh * n_parts + part) * group;
  if (warp < GP) {
    const int g = warp;
    const bool head = g < group;
    const float scale2 = sm_scale * LOG2E;
    float x[T / 32];
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < T / 32; ++j) {
      const int tt = lane + 32 * j;
      float a = Sp[g * T + tt];
#pragma unroll
      for (int s2 = 1; s2 < S; ++s2) a += Sp[(s2 * GP + g) * T + tt];
      x[j] = head && tt < nv ? a * scale2 : NEG_INF;
      mx = fmaxf(mx, x[j]);
    }
    mx = warp_max(mx);                   // finite for a head: token t0 is valid
    float ls = 0.f;
#pragma unroll
    for (int j = 0; j < T / 32; ++j) {
      const int tt = lane + 32 * j;
      const float p = head && tt < nv ? exp2f(x[j] - mx) : 0.f;
      ls += p;
      Ps[tt * GP + g] = p;
    }
    ls = warp_sum(ls);
    if (lane == 0) {
      red_l[g] = ls;
      if (head && n_p > 1) {
        m_part[prow + g] = mx;
        l_part[prow + g] = ls;
      }
    }
  }
  cp_async_wait<0>();                    // V has landed
  __syncthreads();

  // P V: thread (column c, token group tg), all GP heads per V load
  const int c = tid % CH, tg = tid / CH;
  float4 acc[GP];
#pragma unroll
  for (int g = 0; g < GP; ++g) acc[g] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
  for (int tt = tg; tt < nv; tt += TG) {
    const float4 vv = *reinterpret_cast<const float4*>(Vs + tt * DP + c * 4);
#pragma unroll
    for (int g4 = 0; g4 < GP; g4 += 4) {
      const float4 p4 = *reinterpret_cast<const float4*>(Ps + tt * GP + g4);
      const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float4& a = acc[g4 + e];
        a.x = fmaf(p[e], vv.x, a.x);
        a.y = fmaf(p[e], vv.y, a.y);
        a.z = fmaf(p[e], vv.z, a.z);
        a.w = fmaf(p[e], vv.w, a.w);
      }
    }
  }
  __syncthreads();                       // V and P read: both stages take the sums
#pragma unroll
  for (int g = 0; g < GP; ++g) R[(tg * GP + g) * CH + c] = acc[g];
  __syncthreads();
  // the token groups' sums in group order: the output (one partition) or
  // the block's partial
  for (int i = tid; i < GP * CH; i += DEC32_THREADS) {
    const int g = i / CH, d = (i % CH) * 4;
    if (g >= group || d >= D) continue;
    float4 a = R[i];
#pragma unroll
    for (int j = 1; j < TG; ++j) {
      const float4 r = R[j * GP * CH + i];
      a.x += r.x;
      a.y += r.y;
      a.z += r.z;
      a.w += r.w;
    }
    if (n_p == 1)
      store4(ob + g * D + d, a, 1.f / fmaxf(red_l[g], 1e-30f));
    else
      *reinterpret_cast<float4*>(acc_part + (prow + g) * D + d) = a;
  }
  if (n_p == 1) return;
  last_ticket_merge<DEC32_THREADS, MERGE_BATCH_F32>(m_part, l_part, acc_part, tickets + bh,
                                                    bh * n_parts * group, n_p, group, D, ob,
                                                    reinterpret_cast<float*>(smem4));
}

// ---------------------------------------------------------------------
// prefill window, f32, CUDA cores: grid (B, ceil(C / block_q), H_kv),
// PF32_GROUPS token groups of 128 threads.  The block owns window rows
// [q0, q0 + block_q) x the group of query heads of KV head h: R = rows x
// group <= PF_ROWS score rows, row r -> window row q0 + r / group, head
// h * group + r % group.  Row j sits at position start + j and sees the
// first start + j + 1 paged tokens (within the table's reach); rows
// j >= n_tok see none and come out zero.  Token group g walks context
// tiles g, g + PF32_GROUPS, ... of T tokens with its own state; thread
// (ty, tx) of a group holds score rows ty * 8 .. +8 of columns tx + 16 j
// and output dims tx * 4 + 64 j.  DP: the head dim padded to 64 / 128 /
// 256 (zeros past D in shared memory).
// ---------------------------------------------------------------------
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(grp + 1), "n"(PF32_GROUP_THREADS) : "memory");
}

template <int DP, int T>
__global__ void __launch_bounds__(PF32_GROUPS * PF32_GROUP_THREADS, 1)
paged_prefill_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const int32_t* __restrict__ block_tables,
                         const int32_t* __restrict__ starts, const int32_t* __restrict__ n_toks,
                         float* __restrict__ out, int C, int H, int Hkv, int D, int P,
                         int n_slots, int64_t k_page_stride, int64_t v_page_stride,
                         float sm_scale, int block_q) {
  constexpr int LD = DP + PF32_PAD;
  constexpr int TN = T / 16;             // score columns per thread
  constexpr int NV = DP / 64;            // float4 output groups per thread
  constexpr int CH = DP / 4;             // 16-byte chunks per row
  constexpr int GT = PF32_GROUP_THREADS;
  static_assert(2 * T >= PF_ROWS, "a group's K and V tiles hold its partial output");
  extern __shared__ float4 smem4[];
  __shared__ int lim_s[PF_ROWS];         // row r sees tokens < lim_s[r]
  __shared__ int64_t qoff_s[PF_ROWS];    // row r's offset in q and out

  // blocks are dispatched in linear order: the last q block of every
  // (sequence, KV head), whose rows see the most context, goes first
  const int lin = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const int b = lin % gridDim.x, h = lin / gridDim.x % gridDim.z;
  const int q0 = (gridDim.y - 1 - lin / (gridDim.x * gridDim.z)) * block_q;
  const int group = H / Hkv;
  const int R = min(block_q, C - q0) * group;
  const int start = starts[b], ntok = n_toks[b];
  const int tid = threadIdx.x, grp = tid / GT, gtid = tid % GT;
  const int tx = gtid & 15, ty = gtid >> 4;
  float* Qs = reinterpret_cast<float*>(smem4);                        // PF_ROWS x LD
  float* Ks = Qs + PF_ROWS * LD + grp * (2 * T * LD + T * PF32_LDP);  // T x LD
  float* Vs = Ks + T * LD;                                            // T x LD
  float* Pt = Vs + T * LD;                                            // Pt[col][row]

  if (tid < PF_ROWS) {
    const int j = q0 + tid / group, gg = tid % group;
    lim_s[tid] = (tid < R && j < ntok) ? min(start + j + 1, n_slots * P) : 0;
    qoff_s[tid] = (((int64_t)b * C + j) * H + (int64_t)h * group + gg) * D;
  }
  __syncthreads();
  // the last token any row of the block sees, within the table's reach
  const int last_row = min(q0 + block_q, ntok) - 1;
  const int walk = last_row >= q0 ? min(start + last_row + 1, n_slots * P) : 0;
  const int n_tiles = (walk + T - 1) / T;

  const int32_t* bt = block_tables + (int64_t)b * n_slots;
  const int64_t tok_stride = (int64_t)Hkv * D;
  // tile kt of K or V, gathered through the block table; tokens past the
  // walk and dims past D are zero
  auto stage = [&](float* dst, const float* src, int64_t page_stride, int kt) {
#pragma unroll 4
    for (int i = gtid; i < T * CH; i += GT) {
      const int r = i / CH, d = (i % CH) * 4, t = kt * T + r;
      const bool ok = t < walk && d < D;
      int64_t off = 0;
      if (ok)
        off = (int64_t)bt[t / P] * page_stride + (int64_t)(t % P) * tok_stride +
              (int64_t)h * D + d;
      cp_async16(dst + r * LD + d, src + off, ok ? VEC_BYTES : 0);
    }
  };
  for (int i = tid; i < PF_ROWS * CH; i += PF32_GROUPS * GT) {
    const int r = i / CH, d = (i % CH) * 4;
    const bool ok = lim_s[r] > 0 && d < D;
    cp_async16(Qs + r * LD + d, ok ? q + qoff_s[r] + d : q, ok ? VEC_BYTES : 0);
  }
  cp_async_commit();
  // ring of each group: K tile kt lands while P V of tile kt - G runs,
  // V tile kt while the scores of tile kt run
  if (grp < n_tiles) stage(Ks, k, k_page_stride, grp);
  cp_async_commit();
  if (grp < n_tiles) stage(Vs, v, v_page_stride, grp);
  cp_async_commit();
  cp_async_wait<2>();                    // Q has landed
  __syncthreads();

  int lim[8];
  int seen_max = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    lim[i] = lim_s[ty * 8 + i];
    seen_max = max(seen_max, lim[i]);
  }
  // the last token any of this warp's 16 rows sees (warp-uniform skip)
  const int warp_walk = __reduce_max_sync(0xffffffffu, seen_max);
  const float scale2 = sm_scale * LOG2E;
  float m[8], l[8], acc[8][4 * NV];      // m in base 2; l this thread's share
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * NV; ++j) acc[i][j] = 0.f;
  }

  for (int kt = grp; kt < n_tiles; kt += PF32_GROUPS) {
    const int t0 = kt * T;
    const bool seen = t0 < warp_walk;
    cp_async_wait<1>();                  // K tile kt has landed
    group_sync(grp);
    if (seen) {
      float s[8][TN];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
      const float* qrow = Qs + ty * 8 * LD;
      const float* krow = Ks + tx * LD;
#pragma unroll 2
      for (int d = 0; d < DP; d += 4) {
        float4 kv[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j)
          kv[j] = *reinterpret_cast<const float4*>(krow + j * 16 * LD + d);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 qv = *reinterpret_cast<const float4*>(qrow + i * LD + d);
#pragma unroll
          for (int j = 0; j < TN; ++j) s[i][j] = dot4(qv, kv[j], s[i][j]);
        }
      }
      // each row masked at its own causal limit, once per tile; p re-masked
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          s[i][j] = t0 + tx + 16 * j < lim[i] ? s[i][j] * scale2 : NEG_INF;
          mx = fmaxf(mx, s[i][j]);
        }
        const float m_new = fmaxf(m[i], half_warp_max(mx));
        const float alpha = exp2f(m[i] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const float p = t0 + tx + 16 * j < lim[i] ? exp2f(s[i][j] - m_new) : 0.f;
          psum += p;
          Pt[(tx + 16 * j) * PF32_LDP + ty * 8 + i] = p;
        }
        l[i] = l[i] * alpha + psum;
        m[i] = m_new;
#pragma unroll
        for (int j = 0; j < 4 * NV; ++j) acc[i][j] *= alpha;
      }
    }
    group_sync(grp);                     // K buffer free, P complete
    if (kt + PF32_GROUPS < n_tiles) stage(Ks, k, k_page_stride, kt + PF32_GROUPS);
    cp_async_commit();
    cp_async_wait<1>();                  // V tile kt has landed
    group_sync(grp);
    if (seen) {
#pragma unroll 4
      for (int c = 0; c < T; ++c) {
        const float4 pa = *reinterpret_cast<const float4*>(Pt + c * PF32_LDP + ty * 8);
        const float4 pb = *reinterpret_cast<const float4*>(Pt + c * PF32_LDP + ty * 8 + 4);
        const float p[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const float4 vv = *reinterpret_cast<const float4*>(Vs + c * LD + tx * 4 + 64 * j);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[i][4 * j + 0] = fmaf(p[i], vv.x, acc[i][4 * j + 0]);
            acc[i][4 * j + 1] = fmaf(p[i], vv.y, acc[i][4 * j + 1]);
            acc[i][4 * j + 2] = fmaf(p[i], vv.z, acc[i][4 * j + 2]);
            acc[i][4 * j + 3] = fmaf(p[i], vv.w, acc[i][4 * j + 3]);
          }
        }
      }
    }
    group_sync(grp);                     // V buffer and P free
    if (kt + PF32_GROUPS < n_tiles) stage(Vs, v, v_page_stride, kt + PF32_GROUPS);
    cp_async_commit();
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 8; ++i) l[i] = half_warp_sum(l[i]);

  if (PF32_GROUPS > 1) {
    // groups 1.. leave (m, l, acc) in their own K/V and P buffers; group 0
    // merges them into its state
    __syncthreads();
    if (grp > 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = ty * 8 + i;
#pragma unroll
        for (int j = 0; j < NV; ++j)
          *reinterpret_cast<float4*>(Ks + r * LD + tx * 4 + 64 * j) =
              make_float4(acc[i][4 * j], acc[i][4 * j + 1], acc[i][4 * j + 2],
                          acc[i][4 * j + 3]);
        if (tx == 0) {
          Pt[r] = m[i];
          Pt[PF_ROWS + r] = l[i];
        }
      }
    }
    __syncthreads();
    if (grp > 0) return;
#pragma unroll
    for (int g = 1; g < PF32_GROUPS; ++g) {
      const float* Ko = Qs + PF_ROWS * LD + g * (2 * T * LD + T * PF32_LDP);
      const float* Po = Ko + 2 * T * LD;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = ty * 8 + i;
        const float mo = Po[r], M = fmaxf(m[i], mo);
        const float c0 = exp2f(m[i] - M), c1 = exp2f(mo - M);
        l[i] = c0 * l[i] + c1 * Po[PF_ROWS + r];
        m[i] = M;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const float4 o = *reinterpret_cast<const float4*>(Ko + r * LD + tx * 4 + 64 * j);
          acc[i][4 * j + 0] = fmaf(c1, o.x, c0 * acc[i][4 * j + 0]);
          acc[i][4 * j + 1] = fmaf(c1, o.y, c0 * acc[i][4 * j + 1]);
          acc[i][4 * j + 2] = fmaf(c1, o.z, c0 * acc[i][4 * j + 2]);
          acc[i][4 * j + 3] = fmaf(c1, o.w, c0 * acc[i][4 * j + 3]);
        }
      }
    }
  }

  // rows j >= n_tok (lim 0) are written as exact zeros
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty * 8 + i;
    if (r >= R) continue;
    const float inv = lim[i] > 0 ? 1.f / fmaxf(l[i], 1e-30f) : 0.f;
    float* orow = out + qoff_s[r];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int d = tx * 4 + 64 * j;
      if (d < D)
        *reinterpret_cast<float4*>(orow + d) =
            make_float4(acc[i][4 * j] * inv, acc[i][4 * j + 1] * inv,
                        acc[i][4 * j + 2] * inv, acc[i][4 * j + 3] * inv);
    }
  }
}

// ---------------------------------------------------------------------
// prefill window, bf16, tensor cores: grid (B, ceil(C / block_q), H_kv),
// PF_THREADS threads.  Rows as in paged_prefill_kernel (R = rows x group
// <= PF_ROWS); warp w owns score rows 16 w .. 16 w + 15.  DP: the head
// dim padded to 64 / 128 / 256 (zeros past D in shared memory).
// ---------------------------------------------------------------------
template <int DP>
__global__ void __launch_bounds__(PF_THREADS)
paged_prefill_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const int32_t* __restrict__ block_tables,
                         const int32_t* __restrict__ starts, const int32_t* __restrict__ n_toks,
                         __nv_bfloat16* __restrict__ out, int C, int H, int Hkv, int D, int P,
                         int n_slots, int64_t k_page_stride, int64_t v_page_stride,
                         float sm_scale, int block_q) {
  using bf16 = __nv_bfloat16;
  constexpr int VEC = VEC_BYTES / sizeof(bf16);
  constexpr int CH = DP / VEC;           // 16-byte chunks per row (power of two)
  constexpr int KSTEPS = DP / 16;
  constexpr int NT = PF_TOKENS / 8;      // score n-tiles of a warp
  constexpr int DT = DP / 8;             // output n-tiles of a warp
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);     // PF_ROWS x DP, swizzled
  bf16* Ks = Qs + PF_ROWS * DP;                  // 2 stages x PF_TOKENS x DP
  bf16* Vs = Ks + 2 * PF_TOKENS * DP;
  __shared__ int lim_s[PF_ROWS];                 // row r sees tokens < lim_s[r],
                                                 // within the table's reach
  __shared__ int64_t qoff_s[PF_ROWS];            // row r's offset in q and out

  const int b = blockIdx.x, q0 = blockIdx.y * block_q, h = blockIdx.z;
  const int group = H / Hkv;
  const int R = min(block_q, C - q0) * group;
  const int start = starts[b], ntok = n_toks[b];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;

  if (tid < PF_ROWS) {
    const int j = q0 + tid / group, gg = tid % group;
    lim_s[tid] = (tid < R && j < ntok) ? min(start + j + 1, n_slots * P) : 0;
    qoff_s[tid] = (((int64_t)b * C + j) * H + (int64_t)h * group + gg) * D;
  }
  __syncthreads();
  // the last token any row of the block sees, within the table's reach
  const int last_row = min(q0 + block_q, ntok) - 1;
  const int walk = last_row >= q0 ? min(start + last_row + 1, n_slots * P) : 0;
  const int n_tiles = (walk + PF_TOKENS - 1) / PF_TOKENS;

  const int32_t* bt = block_tables + (int64_t)b * n_slots;
  const int64_t tok_stride = (int64_t)Hkv * D;
  auto stage_kv = [&](int kt, int stage) {
    bf16* kd = Ks + stage * PF_TOKENS * DP;
    bf16* vd = Vs + stage * PF_TOKENS * DP;
#pragma unroll
    for (int i = tid; i < PF_TOKENS * CH; i += PF_THREADS) {
      const int r = i / CH, c = i % CH, d = c * VEC, t = kt * PF_TOKENS + r;
      const bool ok = t < walk && d < D;
      int64_t ko = 0, vo = 0;
      if (ok) {
        const int64_t page = bt[t / P];
        const int64_t in_page = (int64_t)(t % P) * tok_stride + (int64_t)h * D + d;
        ko = page * k_page_stride + in_page;
        vo = page * v_page_stride + in_page;
      }
      const int bytes = ok ? min(VEC_BYTES, (D - d) * (int)sizeof(bf16)) : 0;
      cp_async16(kd + swz<DP>(r, c), k + ko, bytes);
      cp_async16(vd + swz<DP>(r, c), v + vo, bytes);
    }
  };
#pragma unroll
  for (int i = tid; i < PF_ROWS * CH; i += PF_THREADS) {
    const int r = i / CH, c = i % CH, d = c * VEC;
    const bool ok = lim_s[r] > 0 && d < D;
    cp_async16(Qs + swz<DP>(r, c), ok ? q + qoff_s[r] + d : q,
               ok ? min(VEC_BYTES, (D - d) * (int)sizeof(bf16)) : 0);
  }
  if (n_tiles > 0) stage_kv(0, 0);
  cp_async_commit();

  const int ra = warp * 16 + g, rb = ra + 8;
  const int lim_a = lim_s[ra], lim_b = lim_s[rb];
  const int warp_walk = __reduce_max_sync(0xffffffffu, max(lim_a, lim_b));
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};   // rows ra, rb; base 2
  const float scale2 = sm_scale * LOG2E;

  for (int kt = 0, stage = 0; kt < n_tiles; ++kt, stage ^= 1) {
    const int t0 = kt * PF_TOKENS;
    if (kt + 1 < n_tiles) stage_kv(kt + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                  // tile kt (and Q) have landed
    __syncthreads();
    if (t0 < warp_walk) {
      const bf16* Kt = Ks + stage * PF_TOKENS * DP;
      const bf16* Vt = Vs + stage * PF_TOKENS * DP;
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, Qs + swz<DP>(warp * 16 + (lane & 15), kk * 2 + (lane >> 4)));
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t kb[4];
          ldmatrix_x4(kb, Kt + swz<DP>(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                       kk * 2 + ((lane >> 3) & 1)));
          mma_bf16_16816(s[2 * np], a, kb[0], kb[1]);
          mma_bf16_16816(s[2 * np + 1], a, kb[2], kb[3]);
        }
      }
      // each row masked at its own causal limit; p re-masked to 0
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = t0 + j * 8 + tig * 2 + (e & 1);
          s[j][e] = t < (e < 2 ? lim_a : lim_b) ? s[j][e] * scale2 : NEG_INF;
        }
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
      const float mn0 = fmaxf(m[0], quad_max(mx0)), mn1 = fmaxf(m[1], quad_max(mx1));
      const float al0 = exp2f(m[0] - mn0), al1 = exp2f(m[1] - mn1);
      m[0] = mn0;
      m[1] = mn1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = t0 + j * 8 + tig * 2 + (e & 1);
          const bool ok = t < (e < 2 ? lim_a : lim_b);
          s[j][e] = ok ? exp2f(s[j][e] - (e < 2 ? mn0 : mn1)) : 0.f;
        }
        ps0 += s[j][0] + s[j][1];
        ps1 += s[j][2] + s[j][3];
      }
      l[0] = l[0] * al0 + ps0;
      l[1] = l[1] * al1 + ps1;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        acc[j][0] *= al0;
        acc[j][1] *= al0;
        acc[j][2] *= al1;
        acc[j][3] *= al1;
      }
#pragma unroll
      for (int c = 0; c < PF_TOKENS / 16; ++c) {
        const uint32_t pa[4] = {pack_bf16x2(s[2 * c][0], s[2 * c][1]),
                                pack_bf16x2(s[2 * c][2], s[2 * c][3]),
                                pack_bf16x2(s[2 * c + 1][0], s[2 * c + 1][1]),
                                pack_bf16x2(s[2 * c + 1][2], s[2 * c + 1][3])};
#pragma unroll
        for (int dp = 0; dp < DT / 2; ++dp) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, Vt + swz<DP>(c * 16 + (lane & 15), dp * 2 + (lane >> 4)));
          mma_bf16_16816(acc[2 * dp], pa, vb[0], vb[1]);
          mma_bf16_16816(acc[2 * dp + 1], pa, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();                     // this stage is free for tile kt + 2
  }
  cp_async_wait<0>();

  const float l0 = quad_sum(l[0]), l1 = quad_sum(l[1]);
  // rows j >= n_tok (lim 0) are written as exact zeros
  const float inv0 = lim_a > 0 ? 1.f / fmaxf(l0, 1e-30f) : 0.f;
  const float inv1 = lim_b > 0 ? 1.f / fmaxf(l1, 1e-30f) : 0.f;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int d = j * 8 + tig * 2;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e < 2 ? ra : rb;
      if (r < R && d + (e & 1) < D)
        out[qoff_s[r] + d + (e & 1)] = __float2bfloat16(acc[j][e] * (e < 2 ? inv0 : inv1));
    }
  }
}

template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

constexpr size_t decode_bf16_smem_bytes(int dp) {
  return (size_t)2 * DEC_TOKENS * dp * sizeof(__nv_bfloat16);
}

template <int DP>
int launch_decode_bf16_dp(const void* q, const void* k, const void* v, const void* bt,
                          const void* lens, void* mp, void* lp, void* ap, void* tickets,
                          void* out, int B, int H, int Hkv, int D, int P, int n_slots,
                          long long kps, long long vps, float sc, cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  const size_t bytes = decode_bf16_smem_bytes(DP);
  auto kernel = paged_decode_bf16_kernel<DP>;
  int err = allow_smem(kernel, bytes);
  if (err) return err;
  const int n_parts = (n_slots * P + DEC_TOKENS - 1) / DEC_TOKENS;
  kernel<<<dim3(Hkv, B, n_parts), DEC_THREADS, bytes, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int32_t*)bt,
      (const int32_t*)lens, (float*)mp, (float*)lp, (float*)ap, (int*)tickets, (bf16*)out, H,
      Hkv, D, P, n_slots, kps, vps, sc);
  return (int)cudaGetLastError();
}

template <int DP, int GP>
int launch_decode_f32_dp(const void* q, const void* k, const void* v, const void* bt,
                         const void* lens, void* mp, void* lp, void* ap, void* tickets,
                         void* out, int B, int H, int Hkv, int D, int P, int n_slots,
                         long long kps, long long vps, float sc, cudaStream_t st) {
  constexpr int T = dec32_tokens(DP);
  const size_t bytes = decode_f32_smem_bytes(DP);
  auto kernel = paged_decode_f32_kernel<DP, T, GP>;
  int err = allow_smem(kernel, bytes);
  if (err) return err;
  const int n_parts = (n_slots * P + T - 1) / T;
  kernel<<<dim3(Hkv, B, n_parts), DEC32_THREADS, bytes, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const int32_t*)bt,
      (const int32_t*)lens, (float*)mp, (float*)lp, (float*)ap, (int*)tickets, (float*)out, H,
      Hkv, D, P, n_slots, kps, vps, sc);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_decode_f32_g(const void* q, const void* k, const void* v, const void* bt,
                        const void* lens, void* mp, void* lp, void* ap, void* tickets,
                        void* out, int B, int H, int Hkv, int D, int P, int n_slots,
                        long long kps, long long vps, float sc, cudaStream_t st) {
  if (H / Hkv <= 4)
    return launch_decode_f32_dp<DP, 4>(q, k, v, bt, lens, mp, lp, ap, tickets, out, B, H, Hkv,
                                       D, P, n_slots, kps, vps, sc, st);
  return launch_decode_f32_dp<DP, 8>(q, k, v, bt, lens, mp, lp, ap, tickets, out, B, H, Hkv, D,
                                     P, n_slots, kps, vps, sc, st);
}

// blocks of the f32 decode body resident per SM (its registers and shared
// memory at a group of 4), or -1 on an error
template <int DP>
int decode_f32_occupancy() {
  auto kernel = paged_decode_f32_kernel<DP, dec32_tokens(DP), 4>;
  const size_t bytes = decode_f32_smem_bytes(DP);
  int blocks = 0;
  if (allow_smem(kernel, bytes) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, DEC32_THREADS, bytes) !=
          cudaSuccess)
    return -1;
  return blocks;
}

constexpr int pf32_tokens(int dp) { return dp >= 256 ? PF32_TOKENS_D256 : PF32_TOKENS; }

constexpr size_t prefill_f32_smem_bytes(int dp) {
  return ((size_t)PF_ROWS * (dp + PF32_PAD) +
          (size_t)PF32_GROUPS * pf32_tokens(dp) * (2 * (dp + PF32_PAD) + PF32_LDP)) *
         sizeof(float);
}

template <int DP>
int launch_prefill_f32_dp(const void* q, const void* k, const void* v, const void* bt,
                          const void* starts, const void* ntoks, void* out, int B, int C,
                          int H, int Hkv, int D, int P, int n_slots, long long kps,
                          long long vps, float sc, int block_q, cudaStream_t st) {
  const size_t bytes = prefill_f32_smem_bytes(DP);
  auto kernel = paged_prefill_f32_kernel<DP, pf32_tokens(DP)>;
  int err = allow_smem(kernel, bytes);
  if (err) return err;
  dim3 grid(B, (C + block_q - 1) / block_q, Hkv);
  kernel<<<grid, PF32_GROUPS * PF32_GROUP_THREADS, bytes, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const int32_t*)bt,
      (const int32_t*)starts, (const int32_t*)ntoks, (float*)out, C, H, Hkv, D, P, n_slots,
      kps, vps, sc, block_q);
  return (int)cudaGetLastError();
}

template <int DP>
int prefill_f32_occupancy() {
  auto kernel = paged_prefill_f32_kernel<DP, pf32_tokens(DP)>;
  const size_t bytes = prefill_f32_smem_bytes(DP);
  int blocks = 0;
  if (allow_smem(kernel, bytes) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kernel, PF32_GROUPS * PF32_GROUP_THREADS, bytes) != cudaSuccess)
    return -1;
  return blocks;
}

int launch_prefill_f32(const void* q, const void* k, const void* v, const void* bt,
                       const void* starts, const void* ntoks, void* out, int B, int C, int H,
                       int Hkv, int D, int P, int n_slots, long long kps, long long vps,
                       float sc, int block_q, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D <= 64)
    return launch_prefill_f32_dp<64>(q, k, v, bt, starts, ntoks, out, B, C, H, Hkv, D, P,
                                     n_slots, kps, vps, sc, block_q, st);
  if (D <= 128)
    return launch_prefill_f32_dp<128>(q, k, v, bt, starts, ntoks, out, B, C, H, Hkv, D, P,
                                      n_slots, kps, vps, sc, block_q, st);
  return launch_prefill_f32_dp<256>(q, k, v, bt, starts, ntoks, out, B, C, H, Hkv, D, P,
                                    n_slots, kps, vps, sc, block_q, st);
}

constexpr size_t prefill_mma_smem_bytes(int dp) {
  return (size_t)(PF_ROWS + 4 * PF_TOKENS) * dp * sizeof(__nv_bfloat16);
}

template <int DP>
int launch_prefill_mma_dp(const void* q, const void* k, const void* v, const void* bt,
                          const void* starts, const void* ntoks, void* out, int B, int C,
                          int H, int Hkv, int D, int P, int n_slots, long long kps,
                          long long vps, float sc, int block_q, cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  const size_t bytes = prefill_mma_smem_bytes(DP);
  auto kernel = paged_prefill_mma_kernel<DP>;
  int err = allow_smem(kernel, bytes);
  if (err) return err;
  dim3 grid(B, (C + block_q - 1) / block_q, Hkv);
  kernel<<<grid, PF_THREADS, bytes, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int32_t*)bt,
      (const int32_t*)starts, (const int32_t*)ntoks, (bf16*)out, C, H, Hkv, D, P, n_slots,
      kps, vps, sc, block_q);
  return (int)cudaGetLastError();
}

int launch_prefill_mma(const void* q, const void* k, const void* v, const void* bt,
                       const void* starts, const void* ntoks, void* out, int B, int C, int H,
                       int Hkv, int D, int P, int n_slots, long long kps, long long vps,
                       float sc, int block_q, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D <= 64)
    return launch_prefill_mma_dp<64>(q, k, v, bt, starts, ntoks, out, B, C, H, Hkv, D, P,
                                     n_slots, kps, vps, sc, block_q, st);
  if (D <= 128)
    return launch_prefill_mma_dp<128>(q, k, v, bt, starts, ntoks, out, B, C, H, Hkv, D, P,
                                      n_slots, kps, vps, sc, block_q, st);
  return launch_prefill_mma_dp<256>(q, k, v, bt, starts, ntoks, out, B, C, H, Hkv, D, P,
                                    n_slots, kps, vps, sc, block_q, st);
}

}  // namespace

extern "C" {

// Limits the wrappers check before a launch.
int paged_attention_max_head_dim() { return 256; }
int paged_attention_max_group() { return 8; }
int paged_attention_max_window_rows() { return PF_ROWS; }
// the bf16 prefill body: score rows per block, context tokens per tile,
// and the 16-byte copies its q and page rows must be aligned for
int paged_prefill_tile_rows_bf16() { return PF_ROWS; }
int paged_prefill_tile_tokens_bf16() { return PF_TOKENS; }
int paged_attention_vector_bytes() { return VEC_BYTES; }
// dynamic shared memory of a bf16 prefill launch at head dim D
int paged_prefill_smem_bytes_bf16(int D) {
  return (int)prefill_mma_smem_bytes(D <= 64 ? 64 : D <= 128 ? 128 : 256);
}
// the f32 prefill body at head dim D: context tokens per tile, token
// groups per block, and the dynamic shared memory of a launch
int paged_prefill_tile_tokens_f32(int D) {
  return pf32_tokens(D <= 64 ? 64 : D <= 128 ? 128 : 256);
}
int paged_prefill_token_groups_f32() { return PF32_GROUPS; }
int paged_prefill_smem_bytes_f32(int D) {
  return (int)prefill_f32_smem_bytes(D <= 64 ? 64 : D <= 128 ? 128 : 256);
}
// blocks of the f32 prefill body resident per SM at head dim D (its
// registers and shared memory), or -1 on an error
int paged_prefill_blocks_per_sm_f32(int D) {
  return D <= 64 ? prefill_f32_occupancy<64>() : D <= 128 ? prefill_f32_occupancy<128>()
                                                          : prefill_f32_occupancy<256>();
}

// the bf16 decode body: tokens per partition, and its dynamic shared
// memory at head dim D
int paged_decode_partition_tokens_bf16() { return DEC_TOKENS; }
int paged_decode_smem_bytes_bf16(int D) {
  return (int)decode_bf16_smem_bytes(D <= 64 ? 64 : D <= 128 ? 128 : 256);
}
// the f32 decode body at head dim D: tokens per partition, the dynamic
// shared memory of a launch, and its blocks resident per SM (or -1)
int paged_decode_partition_tokens_f32(int D) {
  return dec32_tokens(D <= 64 ? 64 : D <= 128 ? 128 : 256);
}
int paged_decode_smem_bytes_f32(int D) {
  return (int)decode_f32_smem_bytes(D <= 64 ? 64 : D <= 128 ? 128 : 256);
}
int paged_decode_blocks_per_sm_f32(int D) {
  return D <= 64 ? decode_f32_occupancy<64>() : D <= 128 ? decode_f32_occupancy<128>()
                                                          : decode_f32_occupancy<256>();
}

// f32: paged_decode_f32_kernel, one launch; scratch as for bf16 below.
int paged_decode_attention_f32(const void* q, const void* k, const void* v,
                               const void* bt, const void* lens, void* m_part,
                               void* l_part, void* acc_part, void* tickets, void* out,
                               int B, int H, int Hkv, int D, int P, int n_slots,
                               long long k_page_stride, long long v_page_stride,
                               float sm_scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D <= 64)
    return launch_decode_f32_g<64>(q, k, v, bt, lens, m_part, l_part, acc_part, tickets, out,
                                   B, H, Hkv, D, P, n_slots, k_page_stride, v_page_stride,
                                   sm_scale, st);
  if (D <= 128)
    return launch_decode_f32_g<128>(q, k, v, bt, lens, m_part, l_part, acc_part, tickets, out,
                                    B, H, Hkv, D, P, n_slots, k_page_stride, v_page_stride,
                                    sm_scale, st);
  return launch_decode_f32_g<256>(q, k, v, bt, lens, m_part, l_part, acc_part, tickets, out,
                                  B, H, Hkv, D, P, n_slots, k_page_stride, v_page_stride,
                                  sm_scale, st);
}

// bf16: paged_decode_bf16_kernel, one launch.  m_part, l_part: (B, H_kv,
// n_parts, G) f32, acc_part: (B, H_kv, n_parts, G, D) f32 scratch, and
// tickets: (B, H_kv) int32, zero before the first call (each call leaves
// them zero); all from the wrapper's cache, which both bodies share (the
// launches of one stream run one after another).
int paged_decode_attention_bf16(const void* q, const void* k, const void* v,
                                const void* bt, const void* lens, void* m_part,
                                void* l_part, void* acc_part, void* tickets, void* out,
                                int B, int H, int Hkv, int D, int P, int n_slots,
                                long long k_page_stride, long long v_page_stride,
                                float sm_scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D <= 64)
    return launch_decode_bf16_dp<64>(q, k, v, bt, lens, m_part, l_part, acc_part, tickets,
                                     out, B, H, Hkv, D, P, n_slots, k_page_stride,
                                     v_page_stride, sm_scale, st);
  if (D <= 128)
    return launch_decode_bf16_dp<128>(q, k, v, bt, lens, m_part, l_part, acc_part, tickets,
                                      out, B, H, Hkv, D, P, n_slots, k_page_stride,
                                      v_page_stride, sm_scale, st);
  return launch_decode_bf16_dp<256>(q, k, v, bt, lens, m_part, l_part, acc_part, tickets,
                                    out, B, H, Hkv, D, P, n_slots, k_page_stride,
                                    v_page_stride, sm_scale, st);
}

int paged_prefill_attention_f32(const void* q, const void* k, const void* v,
                                const void* bt, const void* starts, const void* ntoks,
                                void* out, int B, int C, int H, int Hkv, int D, int P,
                                int n_slots, long long k_page_stride,
                                long long v_page_stride, float sm_scale, int block_q,
                                void* stream) {
  return launch_prefill_f32(q, k, v, bt, starts, ntoks, out, B, C, H, Hkv, D, P, n_slots,
                            k_page_stride, v_page_stride, sm_scale, block_q, stream);
}

// bf16: paged_prefill_mma_kernel (the f32 entry above: paged_prefill_f32_kernel).
int paged_prefill_attention_bf16(const void* q, const void* k, const void* v,
                                 const void* bt, const void* starts,
                                 const void* ntoks, void* out, int B, int C, int H,
                                 int Hkv, int D, int P, int n_slots,
                                 long long k_page_stride, long long v_page_stride,
                                 float sm_scale, int block_q, void* stream) {
  return launch_prefill_mma(q, k, v, bt, starts, ntoks, out, B, C, H, Hkv, D, P, n_slots,
                            k_page_stride, v_page_stride, sm_scale, block_q, stream);
}

}  // extern "C"
