// The POSH copy engine (paper §4.4), hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel copy_blocked of
// src/repro/kernels/symm_copy.py (body _copy_kernel): the identity copy
// through which the `pallas` communicator backend stages every payload
// of every put/get round.
//
// What bounds it on an H100: bytes.  It reads every byte once and
// writes it once and computes nothing, so the least time is
// 2 * bytes / 3.35 TB/s.  The design follows from that:
//   * the payload is copied as bytes, whatever its dtype, with 16-byte
//     vector loads and stores (uint4) when source and destination share
//     their alignment modulo 16: a scalar head brings both pointers to a
//     16-byte boundary, the bulk moves in vectors, a scalar tail ends it.
//     Pointers that are not co-aligned are copied byte by byte;
//   * the reference pads the payload into a (rows, cols) panel, copies
//     the panel and slices it back: two extra copies on the TPU.  Here
//     the kernel masks the ragged edge itself, so nothing is padded;
//   * the variant's (r, c) block is the tile ONE block copies per
//     iteration of a grid-stride loop (r * c * itemsize bytes), so the
//     variants stay distinct launch shapes, as POSH keeps its memcpy
//     engines distinct; each thread keeps UNROLL vectors in flight;
//   * one launch per staged payload, on the caller's stream: block 0
//     also copies the head and tail bytes.
//
// C interface for ctypes: symm_copy returns cudaGetLastError() of its
// launch as an int (0 = success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;                 // vectors in flight per thread

// Vector path (head >= 0): bytes [0, head) and [tail_off, nbytes) are
// copied by block 0 one byte per thread (fewer than 16 each); the
// 16-byte vectors in between, n_vec of them, in tiles of tile_units
// vectors, block b taking tiles b, b + gridDim.x, ...
// Byte path (head < 0): the whole payload byte by byte, in tiles of
// tile_units bytes.
__global__ void __launch_bounds__(THREADS)
copy_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
            long long nbytes, long long head, long long n_units,
            long long tile_units) {
  const long long n_tiles = (n_units + tile_units - 1) / tile_units;
  if (head < 0) {
    for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const long long lo = t * tile_units;
      const long long hi = lo + tile_units < n_units ? lo + tile_units : n_units;
      for (long long i = lo + threadIdx.x; i < hi; i += THREADS) dst[i] = src[i];
    }
    return;
  }
  const long long tail_off = head + n_units * 16;
  if (blockIdx.x == 0) {
    const long long i = threadIdx.x;
    if (i < head) dst[i] = src[i];
    if (tail_off + i < nbytes) dst[tail_off + i] = src[tail_off + i];
  }
  const uint4* __restrict__ s = reinterpret_cast<const uint4*>(src + head);
  uint4* __restrict__ d = reinterpret_cast<uint4*>(dst + head);
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long lo = t * tile_units;
    const long long hi = lo + tile_units < n_units ? lo + tile_units : n_units;
    for (long long i = lo + threadIdx.x; i < hi; i += (long long)THREADS * UNROLL) {
      uint4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long j = i + (long long)u * THREADS;
        if (j < hi) v[u] = s[j];
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long j = i + (long long)u * THREADS;
        if (j < hi) d[j] = v[u];
      }
    }
  }
}

}  // namespace

extern "C" {

// Copy nbytes (> 0) from src to dst.  tile_bytes is the variant's block
// in bytes (a multiple of 16); max_blocks caps the grid, the
// grid-stride loop covers the rest.
int symm_copy(const void* src, void* dst, long long nbytes, long long tile_bytes,
              int max_blocks, void* stream) {
  const uintptr_t s = (uintptr_t)src, d = (uintptr_t)dst;
  long long head, n_units, tile_units;
  if ((s - d) % 16 != 0 || nbytes < 32) {
    head = -1;                            // byte path
    n_units = nbytes;
    tile_units = tile_bytes;
  } else {
    head = (long long)((16 - (s % 16)) % 16);
    n_units = (nbytes - head) / 16;
    tile_units = tile_bytes / 16;
  }
  long long grid = (n_units + tile_units - 1) / tile_units;
  if (grid > max_blocks) grid = max_blocks;
  if (grid < 1) grid = 1;
  copy_kernel<<<(unsigned)grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)src, (uint8_t*)dst, nbytes, head, n_units, tile_units);
  return (int)cudaGetLastError();
}

}  // extern "C"
