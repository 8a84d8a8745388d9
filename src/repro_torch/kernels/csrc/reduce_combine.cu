// The local combine of the ring reductions, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel combine_blocked of
// src/repro/kernels/reduce_combine.py (body _combine_kernel): the
// elementwise out = op(a, b), op one of sum / prod / max / min, for
// float32, bfloat16 and int32.
//
// Semantics are PyTorch's (and XLA's): bfloat16 is computed in float32
// and rounded once to nearest-even; max and min PROPAGATE NaN, as
// torch.maximum / jnp.maximum do (fmaxf would drop it); otherwise
// max(a, b) = a < b ? b : a and min(a, b) = b < a ? b : a, the order
// std::max / std::min give; int32 wraps.
//
// What bounds it on an H100: bytes.  One operation per element against
// 3 * itemsize bytes moved (two reads, one write), so the least time is
// 3 * bytes / 3.35 TB/s.  The design: 16-byte vector loads and stores
// when all three pointers are 16-byte aligned (4 f32 / 8 bf16 / 4 int32
// per vector) and element by element otherwise; the variant's (r, c)
// block is the tile one block combines per iteration of a grid-stride
// loop, as in the copy engine; the ragged edge is masked, not padded
// (the reference pads both operands into panels and slices the result
// back).  One launch per call, on the caller's stream.
//
// C interface for ctypes: every function returns cudaGetLastError() of
// its launch as an int (0 = success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

enum { OP_SUM = 0, OP_PROD = 1, OP_MAX = 2, OP_MIN = 3 };

template <int OP>
__device__ __forceinline__ float apply_f(float a, float b) {
  if (OP == OP_SUM) return a + b;
  if (OP == OP_PROD) return a * b;
  if (a != a) return a;                   // NaN propagates
  if (b != b) return b;
  if (OP == OP_MAX) return a < b ? b : a;
  return b < a ? b : a;
}

template <int OP>
__device__ __forceinline__ int apply_i(int a, int b) {
  if (OP == OP_SUM) return (int)((unsigned)a + (unsigned)b);   // wraps
  if (OP == OP_PROD) return (int)((unsigned)a * (unsigned)b);
  if (OP == OP_MAX) return a < b ? b : a;
  return b < a ? b : a;
}

template <int OP> __device__ __forceinline__ float op_apply(float a, float b) {
  return apply_f<OP>(a, b);
}
template <int OP> __device__ __forceinline__ int op_apply(int a, int b) {
  return apply_i<OP>(a, b);
}
template <int OP>
__device__ __forceinline__ __nv_bfloat16 op_apply(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __float2bfloat16(apply_f<OP>(__bfloat162float(a), __bfloat162float(b)));
}

// VEC elements per unit (16 bytes, or 1 element on the scalar path).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// n_units units of VEC elements, in tiles of tile_units units; block 0
// also combines the tail elements [n_units * VEC, n) one per thread.
template <typename T, int OP, int VEC>
__global__ void __launch_bounds__(THREADS)
combine_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ o,
               long long n, long long n_units, long long tile_units) {
  using P = Pack<T, VEC>;
  const P* __restrict__ pa = reinterpret_cast<const P*>(a);
  const P* __restrict__ pb = reinterpret_cast<const P*>(b);
  P* __restrict__ po = reinterpret_cast<P*>(o);
  const long long n_tiles = (n_units + tile_units - 1) / tile_units;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long lo = t * tile_units;
    const long long hi = lo + tile_units < n_units ? lo + tile_units : n_units;
    for (long long i = lo + threadIdx.x; i < hi; i += THREADS) {
      const P x = pa[i], y = pb[i];
      P r;
#pragma unroll
      for (int k = 0; k < VEC; ++k) r.v[k] = op_apply<OP>(x.v[k], y.v[k]);
      po[i] = r;
    }
  }
  if (blockIdx.x == 0) {
    const long long i = n_units * VEC + threadIdx.x;
    if (i < n) o[i] = op_apply<OP>(a[i], b[i]);
  }
}

template <typename T, int OP>
int launch_op(const T* a, const T* b, T* o, long long n, long long tile, int max_blocks,
              cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = ((uintptr_t)a % 16 == 0) && ((uintptr_t)b % 16 == 0) &&
                   ((uintptr_t)o % 16 == 0);
  const int v = vec ? VEC : 1;
  const long long n_units = n / v, tile_units = tile / v > 0 ? tile / v : 1;
  long long grid = (n_units + tile_units - 1) / tile_units;
  if (grid > max_blocks) grid = max_blocks;
  if (grid < 1) grid = 1;
  if (vec) {
    combine_kernel<T, OP, VEC><<<(unsigned)grid, THREADS, 0, st>>>(a, b, o, n, n_units,
                                                                  tile_units);
  } else {
    combine_kernel<T, OP, 1><<<(unsigned)grid, THREADS, 0, st>>>(a, b, o, n, n_units,
                                                                tile_units);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* a, const void* b, void* o, long long n, int op, long long tile,
           int max_blocks, void* stream) {
  const T* pa = (const T*)a;
  const T* pb = (const T*)b;
  T* po = (T*)o;
  cudaStream_t st = (cudaStream_t)stream;
  switch (op) {
    case OP_SUM: return launch_op<T, OP_SUM>(pa, pb, po, n, tile, max_blocks, st);
    case OP_PROD: return launch_op<T, OP_PROD>(pa, pb, po, n, tile, max_blocks, st);
    case OP_MAX: return launch_op<T, OP_MAX>(pa, pb, po, n, tile, max_blocks, st);
    case OP_MIN: return launch_op<T, OP_MIN>(pa, pb, po, n, tile, max_blocks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// out[i] = op(a[i], b[i]) for i < n (n > 0); op 0 sum, 1 prod, 2 max,
// 3 min; tile is the variant's block in elements.
int combine_f32(const void* a, const void* b, void* o, long long n, int op, long long tile,
                int max_blocks, void* stream) {
  return launch<float>(a, b, o, n, op, tile, max_blocks, stream);
}
int combine_bf16(const void* a, const void* b, void* o, long long n, int op,
                 long long tile, int max_blocks, void* stream) {
  return launch<__nv_bfloat16>(a, b, o, n, op, tile, max_blocks, stream);
}
int combine_i32(const void* a, const void* b, void* o, long long n, int op, long long tile,
                int max_blocks, void* stream) {
  return launch<int>(a, b, o, n, op, tile, max_blocks, stream);
}

}  // extern "C"
