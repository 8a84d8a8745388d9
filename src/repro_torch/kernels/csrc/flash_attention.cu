// Blocked (flash) attention forward, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention of
// src/repro/kernels/flash_attention.py (body _flash_kernel): causal and/or
// sliding-window softmax attention, GQA through h // (H / H_kv) with no
// K/V replication, f32 accumulation, NEG_INF = -1e30 for masked scores,
// output divided by max(l, 1e-30).  It also writes the row log-sum-exp
// the training backward reads (src/repro/models/flash.py:90):
// lse = m + log(max(l, 1e-30)), or BIG = 3e37 where l == 0.
//
// What bounds it on an H100: operations.  A causal (T x T) attention does
// 4 * T^2 / 2 * D flops per head and reads each Q/K/V row once; at the
// training shape (T = 4096, D = 256, 8 heads on 1 KV head) that is
// 6.9e10 flops for 40 MB in f32, over 1,700 flops per byte.  Two bodies:
//
// flash_fwd_f32_kernel — the training path's dtype, on the CUDA cores
// (67 TFLOP/s; TF32 tensor cores would change the numbers, and the
// trainer pins TF32 off).  What limits an FMA loop fed from shared memory
// is the shared-memory pipe (128 B per clock per SM against 128 FMAs per
// clock), so the design maximises FMAs per shared load and hides the
// loads of the next tile:
//   * grid (B * H, q tiles of BQ = 64 rows), the heaviest causal tiles
//     first; 128 threads as 8 row groups x 16 column threads;
//   * score phase: thread (ty, tx) keeps an 8 x 4 register tile (rows
//     ty*8 .. +8, KV columns tx + 16 j); per 4 depths it makes 12
//     16-byte shared loads for 128 FMAs (10.7 per load; a 4 x 2 tile
//     does 5.3), the 8 Q vectors broadcast over the 16 threads of a
//     half-warp, the K vectors of 16 neighbouring rows conflict-free
//     (rows padded by 4 floats);
//   * P.V phase: the tile's probabilities go to shared memory column-
//     major, so a thread reads its 8 rows' p as two 16-byte broadcasts
//     and 4 V vectors per KV row: 6 loads for 128 FMAs (21.3 per load);
//     the thread owns an 8 x 16 output tile (rows ty*8 .. +8, columns
//     tx*4 + 64 j) — the same rows as its scores, so the online-softmax
//     state of a row lives in the 16 threads of one half-warp;
//   * loads overlap compute: K and V tiles (BKV = 64 rows) alternate
//     through a two-buffer ring of 16-byte cp.async copies — V_j lands
//     while the scores of tile j run, K_{j+1} while P_j V_j runs — with
//     zero fill for ragged rows and head dims (no divides, no converts);
//   * shared memory 212 KB at D = 256 (Q, two ring buffers, P): one
//     block of 4 warps per SM; each thread keeps 128 accumulators.
//
// flash_fwd_bf16_kernel — bf16 on the tensor cores (mma.sync m16n8k16,
// bf16 in, f32 accumulate; 989 TFLOP/s dense bf16 is the bound):
//   * grid (B * H, q tiles of BQ = 128 rows), 8 warps of 16 rows each;
//   * Q (128 x D) and a two-stage ring of K and V tiles (64 x D each)
//     in shared memory, filled by 16-byte cp.async, 16-byte chunks XOR-
//     swizzled by row so every ldmatrix is bank-conflict free; 192 KB at
//     D = 256;
//   * S = Q K^T: Q fragments by ldmatrix, K fragments by ldmatrix (K is
//     the column-major B operand as stored); the online softmax runs on
//     the accumulator fragments, each row's max and sum reduced over the
//     4 threads of a quad, in base 2 (scale * log2 e folded in);
//   * O += P V: the score accumulators are re-packed in registers as the
//     bf16 A operand (no shared-memory round trip), V fragments by
//     ldmatrix.trans; each thread keeps 16 x D / 32 f32 accumulators
//     (128 registers at D = 256);
//   * a warp skips the products of a tile none of its rows can see.
//   P rounded to bf16 is the one rounding the f32 reference does not
//   make; its error and the tolerance it meets are in PERF.md.
//
// Both: ragged T, S and D masked in the kernel; tensors come with their
// strides (the model's (b, t, h, d) layout is read and written in place;
// rows and heads must sit 16 bytes apart, which the wrapper checks);
// whole tiles outside the causal or window range are skipped.  Before a
// row's first valid column its running max is NEG_INF, masked scores
// give p = exp(0) = 1, and the first valid column rescales that state by
// alpha = exp(-1e30 - m) = 0 — the reference's arithmetic, so rows whose
// first tiles are all masked come out right.  Measured at the training
// shape on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, PERF.md):
// f32 2.21 ms, 46% of its 1.03 ms bound; bf16 0.335 ms, 21% of its
// 0.069 ms bound.  wgmma, TMA and warp specialisation are the next step
// (ROADMAP).
//
// C interface for ctypes: the function returns cudaGetLastError() of its
// launch as an int (0 = success).

#include "hopper_util.cuh"

namespace {

using namespace hopper;

constexpr float NEG_INF = -1e30f;
constexpr float BIG = 3.0e37f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int VEC_BYTES = 16;    // every global -> shared copy

// f32 body: tiles and thread layout
constexpr int F_BQ = 64, F_BKV = 64, F_THREADS = 128;
constexpr int F_TM = 8, F_TN = 4;         // score register tile per thread
constexpr int F_PAD = 4;                  // floats of padding per shared row
constexpr int F_LDP = F_BQ + F_PAD;       // P is stored column-major

// bf16 body: tiles
constexpr int B_BQ = 128, B_BKV = 64, B_THREADS = 256;

struct Strides {              // elements; the last dim is contiguous
  long long qb, qh, qt, kb, kh, ks, vb, vh, vs, ob, oh, ot;
};

// Stage ROWS rows of a tile, row r read from src + r * stride, as 16-byte
// cp.async chunks into shared memory (row-major with LD elements per row,
// or XOR-swizzled when SWZ); rows >= valid and columns >= D are zero.
template <typename T, int DP, int ROWS, int THREADS, int LD, bool SWZ>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, long long stride, int valid,
                                           int D, int tid) {
  constexpr int VEC = VEC_BYTES / sizeof(T);
  constexpr int CH = DP / VEC;                  // a power of two: shifts
#pragma unroll
  for (int i = tid; i < ROWS * CH; i += THREADS) {
    const int r = i / CH, c = i % CH, d = c * VEC;
    const bool ok = r < valid && d < D;
    const int bytes = ok ? min(VEC_BYTES, (D - d) * (int)sizeof(T)) : 0;
    T* to = SWZ ? dst + swz<DP>(r, c) : dst + r * LD + d;
    cp_async16(to, ok ? src + (long long)r * stride + d : src, bytes);
  }
}

// The KV tiles [t_lo, t_hi) of BKV columns any row in [row_lo, row_hi]
// can see.
__device__ __forceinline__ void tile_range(int bkv, int row_lo, int row_hi, int S, int kv_len,
                                           int causal, int window, int& t_lo, int& t_hi) {
  int c_lo = 0, c_hi = min(kv_len, S);
  if (causal) c_hi = min(c_hi, row_hi + 1);
  if (window > 0) c_lo = max(0, row_lo - window + 1);
  t_lo = c_lo / bkv;
  t_hi = c_hi > 0 ? (c_hi + bkv - 1) / bkv : 0;
}

__device__ __forceinline__ bool visible(int row, int col, int causal, int window, int kv_len) {
  bool ok = col < kv_len;
  if (causal) ok = ok && col <= row;
  if (window > 0) ok = ok && col > row - window;
  return ok;
}

constexpr size_t f32_smem_bytes(int dp) {
  return ((size_t)(F_BQ + 2 * F_BKV) * (dp + F_PAD) + (size_t)F_BKV * F_LDP) * sizeof(float);
}

constexpr size_t bf16_smem_bytes(int dp) {
  return (size_t)(B_BQ + 4 * B_BKV) * dp * sizeof(__nv_bfloat16);
}

constexpr int padded_dim(int d) { return d <= 64 ? 64 : d <= 128 ? 128 : 256; }

// ---------------------------------------------------------------------
// f32 on the CUDA cores.  DP: the head dim padded to 64 / 128 / 256.
// ---------------------------------------------------------------------
template <int DP>
__global__ void __launch_bounds__(F_THREADS, 1)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int H, int Hkv, int T_, int S, int D, Strides st,
                     float sm_scale, int causal, int window, int q_offset, int kv_len) {
  constexpr int LD = DP + F_PAD;
  constexpr int NV = DP / 64;            // float4 output groups per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // BQ x LD
  float* Ks = Qs + F_BQ * LD;                    // BKV x LD (ring buffer 0)
  float* Vs = Ks + F_BKV * LD;                   // BKV x LD (ring buffer 1)
  float* Pt = Vs + F_BKV * LD;                   // BKV x LDP: Pt[col][row]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * F_BQ;   // heaviest tiles first
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  const float* qp = q + b * st.qb + h * st.qh + (long long)q0 * st.qt;
  const float* kp = k + b * st.kb + kvh * st.kh;
  const float* vp = v + b * st.vb + kvh * st.vh;

  const int row_lo = q_offset + q0;
  int t_lo, t_hi;
  tile_range(F_BKV, row_lo, q_offset + min(q0 + F_BQ, T_) - 1, S, kv_len, causal, window,
             t_lo, t_hi);

  // ring: group 1 = Q + K tile t_lo, group 2 = V tile t_lo
  stage_rows<float, DP, F_BQ, F_THREADS, LD, false>(Qs, qp, st.qt, T_ - q0, D, tid);
  if (t_lo < t_hi)
    stage_rows<float, DP, F_BKV, F_THREADS, LD, false>(
        Ks, kp + (long long)t_lo * F_BKV * st.ks, st.ks, S - t_lo * F_BKV, D, tid);
  cp_async_commit();
  if (t_lo < t_hi)
    stage_rows<float, DP, F_BKV, F_THREADS, LD, false>(
        Vs, vp + (long long)t_lo * F_BKV * st.vs, st.vs, S - t_lo * F_BKV, D, tid);
  cp_async_commit();

  float m[F_TM], l[F_TM], acc[F_TM][4 * NV];
#pragma unroll
  for (int i = 0; i < F_TM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;                          // this thread's share of the row sum
#pragma unroll
    for (int j = 0; j < 4 * NV; ++j) acc[i][j] = 0.f;
  }

  for (int kt = t_lo; kt < t_hi; ++kt) {
    const int k0 = kt * F_BKV;
    cp_async_wait<1>();                  // Q and K tile kt have landed
    __syncthreads();

    float s[F_TM][F_TN];
#pragma unroll
    for (int i = 0; i < F_TM; ++i)
#pragma unroll
      for (int j = 0; j < F_TN; ++j) s[i][j] = 0.f;
    const float* qrow = Qs + ty * F_TM * LD;
    const float* krow = Ks + tx * LD;
#pragma unroll 2
    for (int d = 0; d < DP; d += 4) {
      float4 kv[F_TN];
#pragma unroll
      for (int j = 0; j < F_TN; ++j)
        kv[j] = *reinterpret_cast<const float4*>(krow + j * 16 * LD + d);
#pragma unroll
      for (int i = 0; i < F_TM; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(qrow + i * LD + d);
#pragma unroll
        for (int j = 0; j < F_TN; ++j) s[i][j] = dot4(qv, kv[j], s[i][j]);
      }
    }

    // mask, online softmax per row, probabilities to shared memory
#pragma unroll
    for (int i = 0; i < F_TM; ++i) {
      const int row = row_lo + ty * F_TM + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < F_TN; ++j) {
        s[i][j] = visible(row, k0 + tx + 16 * j, causal, window, kv_len) ? s[i][j] * sm_scale
                                                                         : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < F_TN; ++j) {
        const float p = expf(s[i][j] - m_new);
        psum += p;
        Pt[(tx + 16 * j) * F_LDP + ty * F_TM + i] = p;
      }
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4 * NV; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();                     // K buffer free, P complete
    if (kt + 1 < t_hi)
      stage_rows<float, DP, F_BKV, F_THREADS, LD, false>(
          Ks, kp + (long long)(k0 + F_BKV) * st.ks, st.ks, S - k0 - F_BKV, D, tid);
    cp_async_commit();
    cp_async_wait<1>();                  // V tile kt has landed
    __syncthreads();

    // acc += P V over the tile's KV rows
#pragma unroll 4
    for (int c = 0; c < F_BKV; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(Pt + c * F_LDP + ty * F_TM);
      const float4 pb = *reinterpret_cast<const float4*>(Pt + c * F_LDP + ty * F_TM + 4);
      const float p[F_TM] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const float4 vv = *reinterpret_cast<const float4*>(Vs + c * LD + tx * 4 + 64 * j);
#pragma unroll
        for (int i = 0; i < F_TM; ++i) {
          acc[i][4 * j + 0] = fmaf(p[i], vv.x, acc[i][4 * j + 0]);
          acc[i][4 * j + 1] = fmaf(p[i], vv.y, acc[i][4 * j + 1]);
          acc[i][4 * j + 2] = fmaf(p[i], vv.z, acc[i][4 * j + 2]);
          acc[i][4 * j + 3] = fmaf(p[i], vv.w, acc[i][4 * j + 3]);
        }
      }
    }
    __syncthreads();                     // V buffer and P free
    if (kt + 1 < t_hi)
      stage_rows<float, DP, F_BKV, F_THREADS, LD, false>(
          Vs, vp + (long long)(k0 + F_BKV) * st.vs, st.vs, S - k0 - F_BKV, D, tid);
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < F_TM; ++i) {
    const float lt = half_warp_sum(l[i]);
    const int r = q0 + ty * F_TM + i;
    if (r >= T_) continue;
    const float denom = fmaxf(lt, 1e-30f);
    float* orow = out + b * st.ob + h * st.oh + (long long)r * st.ot;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = tx * 4 + 64 * j + e;
        if (d < D) orow[d] = acc[i][4 * j + e] / denom;
      }
    }
    if (tx == 0) lse[(long long)bh * T_ + r] = lt > 0.f ? m[i] + logf(denom) : BIG;
  }
}

// ---------------------------------------------------------------------
// bf16 on the tensor cores.  DP: the head dim padded to 64 / 128 / 256.
// ---------------------------------------------------------------------
template <int DP>
__global__ void __launch_bounds__(B_THREADS, 1)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, int H, int Hkv, int T_, int S, int D, Strides st,
                      float sm_scale, int causal, int window, int q_offset, int kv_len) {
  using bf16 = __nv_bfloat16;
  constexpr int KSTEPS = DP / 16;        // k-steps of S = Q K^T
  constexpr int NT = B_BKV / 8;          // score n-tiles of a warp
  constexpr int DT = DP / 8;             // output n-tiles of a warp
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);     // BQ x DP, swizzled
  bf16* Ks = Qs + B_BQ * DP;                     // 2 stages x BKV x DP
  bf16* Vs = Ks + 2 * B_BKV * DP;                // 2 stages x BKV x DP

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * B_BQ;   // heaviest tiles first
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;

  const bf16* qp = q + b * st.qb + h * st.qh + (long long)q0 * st.qt;
  const bf16* kp = k + b * st.kb + kvh * st.kh;
  const bf16* vp = v + b * st.vb + kvh * st.vh;

  const int row_lo = q_offset + q0;
  int t_lo, t_hi;
  tile_range(B_BKV, row_lo, q_offset + min(q0 + B_BQ, T_) - 1, S, kv_len, causal, window,
             t_lo, t_hi);

  auto stage_kv = [&](int kt, int stage) {
    const int k0 = kt * B_BKV;
    stage_rows<bf16, DP, B_BKV, B_THREADS, DP, true>(Ks + stage * B_BKV * DP,
                                                     kp + (long long)k0 * st.ks, st.ks,
                                                     S - k0, D, tid);
    stage_rows<bf16, DP, B_BKV, B_THREADS, DP, true>(Vs + stage * B_BKV * DP,
                                                     vp + (long long)k0 * st.vs, st.vs,
                                                     S - k0, D, tid);
  };
  stage_rows<bf16, DP, B_BQ, B_THREADS, DP, true>(Qs, qp, st.qt, T_ - q0, D, tid);
  if (t_lo < t_hi) stage_kv(t_lo, 0);
  cp_async_commit();

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};   // rows g and g + 8, base 2
  const float scale2 = sm_scale * LOG2E;
  const int wrow = row_lo + warp * 16;                  // the warp's first row
  const int row_a = wrow + g, row_b = row_a + 8;

  for (int kt = t_lo, stage = 0; kt < t_hi; ++kt, stage ^= 1) {
    const int k0 = kt * B_BKV;
    if (kt + 1 < t_hi) stage_kv(kt + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                  // tile kt (and Q) have landed
    __syncthreads();

    bool live = k0 < kv_len;
    if (causal) live = live && k0 <= wrow + 15;
    if (window > 0) live = live && k0 + B_BKV - 1 > wrow - window;
    if (live) {
      const bf16* Kt = Ks + stage * B_BKV * DP;
      const bf16* Vt = Vs + stage * B_BKV * DP;
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

      // mask and online softmax on the fragments: this thread holds
      // rows g (s[.][0..1]) and g + 8 (s[.][2..3]), 16 columns each
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + j * 8 + tig * 2 + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          s[j][e] = visible(row, col, causal, window, kv_len) ? s[j][e] * scale2 : NEG_INF;
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
        s[j][0] = exp2f(s[j][0] - mn0);
        s[j][1] = exp2f(s[j][1] - mn0);
        s[j][2] = exp2f(s[j][2] - mn1);
        s[j][3] = exp2f(s[j][3] - mn1);
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

      // O += P V: the score fragments of n-tiles 2c, 2c + 1 are the A
      // fragment of k-chunk c
#pragma unroll
      for (int c = 0; c < B_BKV / 16; ++c) {
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
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  const int ra = q0 + warp * 16 + g, rb = ra + 8;
  bf16* obase = out + b * st.ob + h * st.oh;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int d = j * 8 + tig * 2;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e < 2 ? ra : rb;
      if (r < T_ && d + (e & 1) < D)
        obase[(long long)r * st.ot + d + (e & 1)] =
            __float2bfloat16(acc[j][e] / (e < 2 ? den0 : den1));
    }
  }
  if (tig == 0) {
    if (ra < T_) lse[(long long)bh * T_ + ra] = l0 > 0.f ? m[0] * LN2 + logf(den0) : BIG;
    if (rb < T_) lse[(long long)bh * T_ + rb] = l1 > 0.f ? m[1] * LN2 + logf(den1) : BIG;
  }
}

// ---------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------
template <typename T, int DP>
int launch_dp(const void* q, const void* k, const void* v, void* out, void* lse, int B, int H,
              int Hkv, int T_, int S, int D, const Strides& st, float sm_scale, int causal,
              int window, int q_offset, int kv_len, cudaStream_t stream) {
  constexpr bool F32 = sizeof(T) == 4;
  const size_t bytes = F32 ? f32_smem_bytes(DP) : bf16_smem_bytes(DP);
  const int bq = F32 ? F_BQ : B_BQ;
  dim3 grid(B * H, (T_ + bq - 1) / bq);
  cudaError_t e;
  if constexpr (F32) {
    auto kernel = flash_fwd_f32_kernel<DP>;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, F_THREADS, bytes, stream>>>((const float*)q, (const float*)k,
                                               (const float*)v, (float*)out, (float*)lse, H,
                                               Hkv, T_, S, D, st, sm_scale, causal, window,
                                               q_offset, kv_len);
  } else {
    auto kernel = flash_fwd_bf16_kernel<DP>;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, B_THREADS, bytes, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
        (__nv_bfloat16*)out, (float*)lse, H, Hkv, T_, S, D, st, sm_scale, causal, window,
        q_offset, kv_len);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int B, int H,
           int Hkv, int T_, int S, int D, const long long* strides, float sm_scale,
           int causal, int window, int q_offset, int kv_len, void* stream) {
  const Strides st{strides[0], strides[1], strides[2],  strides[3],
                   strides[4], strides[5], strides[6],  strides[7],
                   strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = (cudaStream_t)stream;
  if (D <= 64)
    return launch_dp<T, 64>(q, k, v, out, lse, B, H, Hkv, T_, S, D, st, sm_scale, causal,
                            window, q_offset, kv_len, s);
  if (D <= 128)
    return launch_dp<T, 128>(q, k, v, out, lse, B, H, Hkv, T_, S, D, st, sm_scale, causal,
                             window, q_offset, kv_len, s);
  if (D <= 256)
    return launch_dp<T, 256>(q, k, v, out, lse, B, H, Hkv, T_, S, D, st, sm_scale, causal,
                             window, q_offset, kv_len, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Limits and tiles the wrapper checks before a launch.
int flash_attention_max_head_dim() { return 256; }
int flash_attention_vector_bytes() { return VEC_BYTES; }
int flash_attention_block_q_f32() { return F_BQ; }
int flash_attention_block_kv_f32() { return F_BKV; }
int flash_attention_block_q_bf16() { return B_BQ; }
int flash_attention_block_kv_bf16() { return B_BKV; }
// dynamic shared memory of a launch at head dim D
int flash_attention_smem_bytes_f32(int D) { return (int)f32_smem_bytes(padded_dim(D)); }
int flash_attention_smem_bytes_bf16(int D) { return (int)bf16_smem_bytes(padded_dim(D)); }

// q (B, H, T, D), k/v (B, H_kv, S, D), out like q, each given by its
// strides (12 values: q, k, v, out, each as batch, head, row); the last
// dim of each is contiguous, and q, k, v start and step 16-byte aligned.
// lse: (B, H, T) f32, contiguous.  window <= 0 means none; kv_len masks
// columns >= kv_len; row i sits at q_offset + i.
int flash_attention_f32(const void* q, const void* k, const void* v, void* out, void* lse,
                        int B, int H, int Hkv, int T, int S, int D, const long long* strides,
                        float sm_scale, int causal, int window, int q_offset, int kv_len,
                        void* stream) {
  return launch<float>(q, k, v, out, lse, B, H, Hkv, T, S, D, strides, sm_scale, causal,
                       window, q_offset, kv_len, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* out, void* lse,
                         int B, int H, int Hkv, int T, int S, int D, const long long* strides,
                         float sm_scale, int causal, int window, int q_offset, int kv_len,
                         void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, lse, B, H, Hkv, T, S, D, strides, sm_scale,
                               causal, window, q_offset, kv_len, stream);
}

}  // extern "C"
