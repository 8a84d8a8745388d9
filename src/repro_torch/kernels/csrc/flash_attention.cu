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
// 6.9e10 flops for 40 MB in f32 — over 1,700 flops per byte.  In f32 the
// honest unit is the CUDA cores (67 TFLOP/s; TF32 tensor cores would
// change the numbers), so the design feeds them from shared memory:
//   * grid (B * H, q tiles); a block owns BQ = 64 query rows, walks the
//     KV sequence in tiles of BKV = 32 rows inside the block (the TPU's
//     sequential KV grid axis with scratch carried across steps becomes
//     this loop), and skips whole tiles outside the causal or window
//     range, as the TPU kernel's `relevant` does;
//   * Q, the K/V tile and the tile's probabilities sit in shared memory
//     as f32 (dynamic, ~139 KB at D = 256, set with
//     cudaFuncSetAttribute), rows padded by 4 floats so that the 16-byte
//     reads of neighbouring rows fall in different banks;
//   * 256 threads as 16 x 16: thread (ty, tx) keeps 4 query rows; it
//     computes their scores against KV rows tx and tx + 16 (a 4 x 2
//     register tile, 32 FMAs per six 16-byte shared loads), and their
//     output columns tx*4 + 64 j (a 4 x D/16 register accumulator);
//   * the online softmax is per row: one float of running max and of
//     running sum per row (the TPU's lane-replicated (bq, 128) scratch
//     is gone), reduced over the 16 threads of a row group, which are one
//     half-warp, by shuffles;
//   * the ragged edges of T, S and D are masked in the kernel — no pad
//     copies; tensors come with their strides (the model's (b, t, h, d)
//     layout is read in place);
//   * the heaviest causal q tiles are scheduled first.
// Before a row's first valid column its running max is NEG_INF, masked
// scores give p = exp(0) = 1, and the first valid column rescales that
// state by alpha = exp(-1e30 - m) = 0 — exactly the reference's
// arithmetic, so rows whose first tiles are all masked come out right.
// Tensor cores (wgmma for bf16), TMA loads and warp specialisation are
// for the PRs that make it fast.
//
// C interface for ctypes: the function returns cudaGetLastError() of its
// launch as an int (0 = success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float BIG = 3.0e37f;
constexpr int BQ = 64;        // query rows per block
constexpr int BKV = 32;       // key/value rows per tile
constexpr int THREADS = 256;  // 16 row groups x 16 threads
constexpr int ROWS = 4;       // query rows per thread
constexpr int PAD = 4;        // floats of padding per shared row
constexpr int LDP = BKV + PAD;

struct Strides {              // elements; the last dim is contiguous
  long long qb, qh, qt, kb, kh, ks, vb, vh, vs, ob, oh, ot;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

constexpr size_t smem_bytes(int dp) {
  return ((size_t)(BQ + 2 * BKV) * (dp + PAD) + (size_t)BQ * LDP) * sizeof(float);
}

// DP: the head dim padded to 64 / 128 / 256 (zeros past D in shared memory).
template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int H, int Hkv, int T_, int S,
                 int D, Strides st, float sm_scale, int causal, int window, int q_offset,
                 int kv_len) {
  constexpr int LD = DP + PAD;
  constexpr int NV = DP / 64;            // float4 output groups per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // BQ x LD
  float* Ks = Qs + BQ * LD;                      // BKV x LD
  float* Vs = Ks + BKV * LD;                     // BKV x LD
  float* Ps = Vs + BKV * LD;                     // BQ x LDP

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest tiles first
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  const T* qp = q + b * st.qb + h * st.qh;
  const T* kp = k + b * st.kb + kvh * st.kh;
  const T* vp = v + b * st.vb + kvh * st.vh;

  for (int i = tid; i < BQ * DP; i += THREADS) {
    const int r = i / DP, d = i % DP;
    Qs[r * LD + d] = (q0 + r < T_ && d < D) ? to_f32(qp[(long long)(q0 + r) * st.qt + d]) : 0.f;
  }

  // the KV columns [c_lo, c_hi) any row of this block can see
  const int row_lo = q_offset + q0;
  const int row_hi = q_offset + min(q0 + BQ, T_) - 1;
  int c_lo = 0, c_hi = min(kv_len, S);
  if (causal) c_hi = min(c_hi, row_hi + 1);
  if (window > 0) c_lo = max(0, row_lo - window + 1);
  const int t_lo = c_lo / BKV;
  const int t_hi = c_hi > 0 ? (c_hi + BKV - 1) / BKV : 0;

  float m[ROWS], l[ROWS], acc[ROWS][4 * NV];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * NV; ++j) acc[i][j] = 0.f;
  }

  for (int kt = t_lo; kt < t_hi; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();                       // the last tile's readers are done
    for (int i = tid; i < BKV * DP; i += THREADS) {
      const int c = i / DP, d = i % DP;
      float kx = 0.f, vx = 0.f;
      if (k0 + c < S && d < D) {
        kx = to_f32(kp[(long long)(k0 + c) * st.ks + d]);
        vx = to_f32(vp[(long long)(k0 + c) * st.vs + d]);
      }
      Ks[c * LD + d] = kx;
      Vs[c * LD + d] = vx;
    }
    __syncthreads();

    // scores of rows ty*4 + i against KV rows tx and tx + 16
    float s[ROWS][2];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; d += 4) {
      float4 qv[ROWS], kv[2];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty * ROWS + i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        s[i][0] = dot4(qv[i], kv[0], s[i][0]);
        s[i][1] = dot4(qv[i], kv[1], s[i][1]);
      }
    }

    // mask, online softmax per row, probabilities to shared memory
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int row = row_lo + ty * ROWS + i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = k0 + tx + 16 * j;
        bool ok = col < kv_len;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && col > row - window;
        s[i][j] = ok ? s[i][j] * sm_scale : NEG_INF;
      }
      const float m_new = fmaxf(m[i], half_warp_max(fmaxf(s[i][0], s[i][1])));
      const float alpha = expf(m[i] - m_new);
      const float p0 = expf(s[i][0] - m_new), p1 = expf(s[i][1] - m_new);
      l[i] = l[i] * alpha + half_warp_sum(p0 + p1);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4 * NV; ++j) acc[i][j] *= alpha;
      Ps[(ty * ROWS + i) * LDP + tx] = p0;
      Ps[(ty * ROWS + i) * LDP + tx + 16] = p1;
    }
    __syncwarp();                          // a row group is one half-warp

    // acc += P V over the tile's 32 KV rows
#pragma unroll 4
    for (int c = 0; c < BKV; ++c) {
      float p[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) p[i] = Ps[(ty * ROWS + i) * LDP + c];
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const float4 vv = *reinterpret_cast<const float4*>(&Vs[c * LD + tx * 4 + 64 * j]);
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          acc[i][4 * j + 0] = fmaf(p[i], vv.x, acc[i][4 * j + 0]);
          acc[i][4 * j + 1] = fmaf(p[i], vv.y, acc[i][4 * j + 1]);
          acc[i][4 * j + 2] = fmaf(p[i], vv.z, acc[i][4 * j + 2]);
          acc[i][4 * j + 3] = fmaf(p[i], vv.w, acc[i][4 * j + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = q0 + ty * ROWS + i;
    if (r >= T_) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = out + b * st.ob + h * st.oh + (long long)r * st.ot;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = tx * 4 + 64 * j + e;
        if (d < D) orow[d] = from_f32<T>(acc[i][4 * j + e] / denom);
      }
    }
    if (tx == 0) lse[(long long)bh * T_ + r] = l[i] > 0.f ? m[i] + logf(denom) : BIG;
  }
}

template <typename T, int DP>
int launch_dp(const void* q, const void* k, const void* v, void* out, void* lse, int B, int H,
              int Hkv, int T_, int S, int D, const Strides& st, float sm_scale, int causal,
              int window, int q_offset, int kv_len, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, DP>;
  const size_t bytes = smem_bytes(DP);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * H, (T_ + BQ - 1) / BQ);
  kernel<<<grid, THREADS, bytes, stream>>>((const T*)q, (const T*)k, (const T*)v, (T*)out,
                                           (float*)lse, H, Hkv, T_, S, D, st, sm_scale,
                                           causal, window, q_offset, kv_len);
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
int flash_attention_block_q() { return BQ; }
int flash_attention_block_kv() { return BKV; }

// q (B, H, T, D), k/v (B, H_kv, S, D), out like q, each given by its
// strides (12 values: q, k, v, out, each as batch, head, row); the last
// dim of each is contiguous.  lse: (B, H, T) f32, contiguous.  window <= 0
// means none; kv_len masks columns >= kv_len; row i sits at q_offset + i.
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
