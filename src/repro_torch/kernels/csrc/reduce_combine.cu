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
// 3 * bytes / 3.35 TB/s, and what reaches it is enough bytes in flight on
// every SM for the whole call.  The design:
//   * the grid is sized to the card, not to the work: the wrapper gives
//     at most BLOCKS_PER_SM blocks of 128 threads per SM, what the SM
//     holds at once (one block per tile when the call has fewer tiles),
//     and each block walks the variant's tiles grid-stride;
//     the variant's (r, c) block is still the tile one block covers per
//     iteration, as in the reference;
//   * inside a tile each thread keeps UNROLL independent 16-byte vector
//     pairs in flight (4 f32 / 8 bf16 / 4 int32 each), all loads of a
//     step issued before its first store (read-once L1::no_allocate loads
//     and streaming .cs stores measured no faster: PERF.md);
//   * when a pointer is not 16-byte aligned the same walk runs element by
//     element (the wrapper says which); the ragged tail past the last
//     whole vector (< one vector) is combined by block 0, masked, not
//     padded (the reference pads both operands into panels and slices the
//     result back).
// One launch per call, on the caller's stream.
//
// C interface for ctypes: every function returns cudaGetLastError() of
// its launch as an int (0 = success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int UNROLL = 4;               // 16-byte vector pairs in flight per thread

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

// n_units units of VEC elements, in tiles of tile_units units, tiles
// grid-stride over the blocks; block 0 also combines the tail elements
// [n_units * VEC, n), fewer than one unit, one per thread.
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
    for (long long i = lo + threadIdx.x; i < hi; i += (long long)THREADS * UNROLL) {
      P x[UNROLL], y[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long j = i + (long long)u * THREADS;
        if (j < hi) {
          x[u] = pa[j];
          y[u] = pb[j];
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long j = i + (long long)u * THREADS;
        if (j < hi) {
          P r;
#pragma unroll
          for (int k = 0; k < VEC; ++k) r.v[k] = op_apply<OP>(x[u].v[k], y[u].v[k]);
          po[j] = r;
        }
      }
    }
  }
  if (blockIdx.x == 0) {
    const long long i = n_units * VEC + threadIdx.x;
    if (i < n) o[i] = op_apply<OP>(a[i], b[i]);
  }
}

template <typename T, int OP>
int launch_op(const T* a, const T* b, T* o, long long n, long long tile, int vec, int grid,
              cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  if (vec) {
    if ((uintptr_t)a % 16 || (uintptr_t)b % 16 || (uintptr_t)o % 16)
      return (int)cudaErrorMisalignedAddress;
  }
  const int v = vec ? VEC : 1;
  const long long n_units = n / v, tile_units = tile / v > 0 ? tile / v : 1;
  if (grid < 1) return (int)cudaErrorInvalidValue;
  if (vec) {
    combine_kernel<T, OP, VEC><<<grid, THREADS, 0, st>>>(a, b, o, n, n_units, tile_units);
  } else {
    combine_kernel<T, OP, 1><<<grid, THREADS, 0, st>>>(a, b, o, n, n_units, tile_units);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* a, const void* b, void* o, long long n, int op, long long tile,
           int vec, int grid, void* stream) {
  const T* pa = (const T*)a;
  const T* pb = (const T*)b;
  T* po = (T*)o;
  cudaStream_t st = (cudaStream_t)stream;
  switch (op) {
    case OP_SUM: return launch_op<T, OP_SUM>(pa, pb, po, n, tile, vec, grid, st);
    case OP_PROD: return launch_op<T, OP_PROD>(pa, pb, po, n, tile, vec, grid, st);
    case OP_MAX: return launch_op<T, OP_MAX>(pa, pb, po, n, tile, vec, grid, st);
    case OP_MIN: return launch_op<T, OP_MIN>(pa, pb, po, n, tile, vec, grid, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// out[i] = op(a[i], b[i]) for i < n (n > 0); op 0 sum, 1 prod, 2 max,
// 3 min; tile is the variant's block in elements; vec 1 takes the
// 16-byte path (all three pointers 16-byte aligned, else an error), 0
// the element path; grid the blocks to launch (combine_grid).
int combine_f32(const void* a, const void* b, void* o, long long n, int op, long long tile,
                int vec, int grid, void* stream) {
  return launch<float>(a, b, o, n, op, tile, vec, grid, stream);
}
int combine_bf16(const void* a, const void* b, void* o, long long n, int op,
                 long long tile, int vec, int grid, void* stream) {
  return launch<__nv_bfloat16>(a, b, o, n, op, tile, vec, grid, stream);
}
int combine_i32(const void* a, const void* b, void* o, long long n, int op, long long tile,
                int vec, int grid, void* stream) {
  return launch<int>(a, b, o, n, op, tile, vec, grid, stream);
}
// what the wrapper sizes its grid by: threads per block and the vector
// pairs each thread keeps in flight
int combine_threads() { return THREADS; }
int combine_unroll() { return UNROLL; }
// blocks of the f32 sum kernel's 16-byte path resident per SM, or -1
int combine_blocks_per_sm() {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, combine_kernel<float, OP_SUM, 4>, THREADS, 0) != cudaSuccess)
    return -1;
  return blocks;
}

}  // extern "C"
