// Paged attention through a block table, hand-written for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/paged_attention.py:
//   paged_decode_attention   (body _paged_kernel)   -> paged_decode_split_kernel
//                                                      + paged_decode_combine_kernel
//   paged_prefill_attention  (body _prefill_kernel) -> paged_prefill_mma_kernel (bf16)
//                                                      paged_prefill_kernel (f32)
//
// Semantics are the reference's to the constant: scores scaled by
// sm_scale, an online softmax in f32, NEG_INF = -1e30 as the empty
// running max, masked (out-of-range) tokens contributing exactly zero —
// the re-masked p = 0 of the reference — and the output divided by
// max(l, 1e-30).  A decode row of length 0 and a window row j >= n_tok
// come out as exact zeros.
//
// What bounds them on an H100: bytes.  Decode reads each K/V token of
// a (sequence, KV head) once and does 4 flops per element (~2 per byte
// in bf16), far under the ~295 flops per byte where the tensor cores
// would become the limit.  The design follows from that:
//   * the page walk stops at the sequence's last valid token (the TPU
//     grid visits every one of the n_slots table slots);
//   * the per-layer K/V is read IN PLACE as a strided view of the whole
//     (n_pages, 2, L, P, H_kv, D) pool: the page stride is an argument;
//   * page ids are read by the kernel itself (no scalar prefetch);
//   * decode splits each sequence's tokens over S blocks (grid
//     B x H_kv x S, S from the wrapper so the grid fills the card) and
//     over the 8 warps of each block, token by token, so many loads are
//     in flight; each warp keeps its rows' (m, l, acc) in registers, the
//     warps merge in shared memory, and a second small kernel merges
//     the S partials (the flash-decoding split);
//   * a lane owns head dims d = lane + 32 i, so a warp's load of one
//     token's K or V row is contiguous.
//
// The prefill window in bf16 (the serving path's dtype) is a tile design
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
// f32 keeps the first body, paged_prefill_kernel (a warp per 8 score
// rows, token by token on the CUDA cores): it is the smoke configs'
// parity path, not the serving path.  The wrapper picks the body by dtype, a fixed dispatch.
//
// C interface for ctypes: every function returns cudaGetLastError() of
// its launches as an int (0 = success).

#include "hopper_util.cuh"

namespace {

using namespace hopper;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int WARPS = 8;                 // warps per block, both kernels
constexpr int THREADS = WARPS * 32;
constexpr int ROWS_PER_WARP = 8;         // prefill score rows per warp
constexpr int COMBINE_THREADS = 128;
constexpr int PF_ROWS = 64;              // bf16 prefill: score rows per block
constexpr int PF_TOKENS = 64;            // bf16 prefill: context tokens per tile
constexpr int PF_THREADS = 128;          // 4 warps x 16 rows
constexpr int VEC_BYTES = 16;
static_assert(PF_ROWS == WARPS * ROWS_PER_WARP, "both prefill bodies take 64 rows");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Sum each of N per-lane partials over the warp.  The N butterflies are
// interleaved so their shuffles overlap instead of forming one long
// dependent chain per row.
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

// ---------------------------------------------------------------------
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
int launch_prefill(const void* q, const void* k, const void* v, const void* bt,
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
int paged_attention_max_window_rows() { return WARPS * ROWS_PER_WARP; }
// the bf16 prefill body: score rows per block, context tokens per tile,
// and the 16-byte copies its q and page rows must be aligned for
int paged_prefill_tile_rows_bf16() { return PF_ROWS; }
int paged_prefill_tile_tokens_bf16() { return PF_TOKENS; }
int paged_attention_vector_bytes() { return VEC_BYTES; }
// dynamic shared memory of a bf16 prefill launch at head dim D
int paged_prefill_smem_bytes_bf16(int D) {
  return (int)prefill_mma_smem_bytes(D <= 64 ? 64 : D <= 128 ? 128 : 256);
}

// m_part, l_part: (B, H, S) f32 and acc_part: (B, H, S, D) f32 scratch
// the wrapper allocates.
int paged_decode_attention_f32(const void* q, const void* k, const void* v,
                               const void* bt, const void* lens, void* m_part,
                               void* l_part, void* acc_part, void* out, int B, int H,
                               int Hkv, int D, int P, int n_slots, long long k_page_stride,
                               long long v_page_stride, float sm_scale, int S,
                               void* stream) {
  return launch_decode<float>(q, k, v, bt, lens, m_part, l_part, acc_part, out, B, H, Hkv,
                              D, P, n_slots, k_page_stride, v_page_stride, sm_scale, S,
                              stream);
}

int paged_decode_attention_bf16(const void* q, const void* k, const void* v,
                                const void* bt, const void* lens, void* m_part,
                                void* l_part, void* acc_part, void* out, int B, int H,
                                int Hkv, int D, int P, int n_slots,
                                long long k_page_stride, long long v_page_stride,
                                float sm_scale, int S, void* stream) {
  return launch_decode<__nv_bfloat16>(q, k, v, bt, lens, m_part, l_part, acc_part, out, B,
                                      H, Hkv, D, P, n_slots, k_page_stride, v_page_stride,
                                      sm_scale, S, stream);
}

int paged_prefill_attention_f32(const void* q, const void* k, const void* v,
                                const void* bt, const void* starts, const void* ntoks,
                                void* out, int B, int C, int H, int Hkv, int D, int P,
                                int n_slots, long long k_page_stride,
                                long long v_page_stride, float sm_scale, int block_q,
                                void* stream) {
  return launch_prefill<float>(q, k, v, bt, starts, ntoks, out, B, C, H, Hkv, D, P,
                               n_slots, k_page_stride, v_page_stride, sm_scale, block_q,
                               stream);
}

// bf16: paged_prefill_mma_kernel; f32: paged_prefill_kernel (fixed by dtype).
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
