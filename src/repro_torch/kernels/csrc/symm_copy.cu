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
//   * the payload is copied as bytes, whatever its dtype.  When source
//     and destination share their alignment modulo 16, the 16-byte
//     aligned bulk in between moves through Hopper's bulk copy engine
//     (TMA, cp.async.bulk): per block a ring of STAGES shared-memory
//     stages of STAGE_BYTES, one elected thread issuing global->shared
//     bulk loads that complete on the stage's mbarrier
//     (complete_tx::bytes) and shared->global bulk stores in bulk groups,
//     waiting (wait_group.read) only before it reuses a stage, and at
//     the end only until its last store has read the ring (the grid's
//     completion covers the writes).  No register holds the data and
//     STAGES - 1 loads stay in flight;
//   * the grid is sized to the SMs (one block of one warp per SM, its
//     ring taking most of the SM's shared memory) and loops over the
//     tiles; the variant's (r, c) block is the tile a block takes per
//     step (r * c * itemsize bytes), so the variants stay distinct
//     launch shapes, as POSH keeps its memcpy engines distinct.  A tile
//     larger than a stage (256 KiB, 1 MiB) moves in stage-sized chunks;
//   * the fewer than 16 head and tail bytes off the 16-byte grid are
//     copied by block 0's lanes, and pointers that are not co-aligned
//     (or payloads under 32 bytes) take the byte path, copy_kernel;
//   * the reference pads the payload into a (rows, cols) panel, copies
//     the panel and slices it back: two extra copies on the TPU.  Here
//     the kernels mask the ragged edge themselves, so nothing is padded;
//   * one launch per staged payload, on the caller's stream.
//
// C interface for ctypes: symm_copy_bulk and symm_copy_bytes return
// cudaGetLastError() of their launch as an int (0 = success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;              // byte path
constexpr int BULK_THREADS = 32;          // one warp: lane 0 drives the ring
constexpr int STAGE_BYTES = 32 * 1024;
constexpr int STAGES = 6;                 // a 192 KiB ring per block
constexpr int RING_BYTES = STAGES * STAGE_BYTES;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// bytes (a multiple of 16) global -> shared, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// bytes (a multiple of 16) shared -> global, in the current bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N bulk groups still read their shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Bulk path.  The payload is [0, head) + bulk [head, head + n_bulk) +
// tail [head + n_bulk, nbytes), head and tail under 16 bytes, src + head
// and dst + head 16-byte aligned, n_bulk a multiple of 16.  The bulk is
// cut in tiles of tile_bytes (a multiple of 16); block x takes tiles x,
// x + gridDim.x, ... and each tile in chunks of at most STAGE_BYTES:
// chunk k of the block is chunk k % cpt of its tile k / cpt (cpt chunks
// per tile; only the payload's last tile can have fewer).
__global__ void __launch_bounds__(BULK_THREADS)
copy_bulk_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                 long long nbytes, long long head, long long n_bulk, long long tile_bytes) {
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ __align__(8) uint64_t bars[STAGES];
  const int lane = threadIdx.x;
  if (blockIdx.x == 0) {
    const long long tail = head + n_bulk;
    if (lane < head) dst[lane] = src[lane];
    if (tail + lane < nbytes) dst[tail + lane] = src[tail + lane];
  }
  if (lane != 0) return;

  const long long n_tiles = (n_bulk + tile_bytes - 1) / tile_bytes;
  const long long cpt = (tile_bytes + STAGE_BYTES - 1) / STAGE_BYTES;
  const long long my_tiles = (n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  if (my_tiles <= 0) return;
  const long long last = blockIdx.x + (my_tiles - 1) * gridDim.x;
  const long long last_len =
      n_bulk - last * tile_bytes < tile_bytes ? n_bulk - last * tile_bytes : tile_bytes;
  const long long n = (my_tiles - 1) * cpt + (last_len + STAGE_BYTES - 1) / STAGE_BYTES;
  const uint8_t* s = src + head;
  uint8_t* d = dst + head;
  // chunk k -> (byte offset in the bulk, bytes)
  auto chunk = [&](long long k, long long& off, int& bytes) {
    const long long tile = blockIdx.x + (k / cpt) * gridDim.x;
    const long long t0 = tile * tile_bytes;
    const long long t1 = t0 + tile_bytes < n_bulk ? t0 + tile_bytes : n_bulk;
    off = t0 + (k % cpt) * STAGE_BYTES;
    bytes = (int)(t1 - off < STAGE_BYTES ? t1 - off : STAGE_BYTES);
  };
  auto load = [&](long long k) {
    long long off;
    int bytes;
    chunk(k, off, bytes);
    uint64_t* bar = &bars[k % STAGES];
    mbar_expect_tx(bar, bytes);
    bulk_load(ring + (k % STAGES) * STAGE_BYTES, s + off, bytes, bar);
  };

  for (int i = 0; i < STAGES; ++i) mbar_init(&bars[i], 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  for (long long k = 0; k < STAGES - 1 && k < n; ++k) load(k);
  for (long long k = 0; k < n; ++k) {
    long long off;
    int bytes;
    chunk(k, off, bytes);
    mbar_wait(&bars[k % STAGES], (int)((k / STAGES) & 1));
    bulk_store(d + off, ring + (k % STAGES) * STAGE_BYTES, bytes);
    bulk_commit();
    // chunk k + STAGES - 1 goes to the stage of chunk k - 1: wait until
    // that chunk's store has read it (chunk k's store may still be reading)
    if (k + STAGES - 1 < n) {
      bulk_wait_read<1>();
      load(k + STAGES - 1);
    }
  }
  bulk_wait_read<0>();                    // the ring is free: the block may end
}

// Byte path: the whole payload byte by byte, in tiles of tile_bytes,
// block b taking tiles b, b + gridDim.x, ...
__global__ void __launch_bounds__(THREADS)
copy_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst, long long nbytes,
            long long tile_bytes) {
  const long long n_tiles = (nbytes + tile_bytes - 1) / tile_bytes;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long lo = t * tile_bytes;
    const long long hi = lo + tile_bytes < nbytes ? lo + tile_bytes : nbytes;
    for (long long i = lo + threadIdx.x; i < hi; i += THREADS) dst[i] = src[i];
  }
}

}  // namespace

extern "C" {

// What the wrapper plans with: a stage's bytes and the ring's.
int symm_copy_stage_bytes() { return STAGE_BYTES; }
int symm_copy_ring_bytes() { return RING_BYTES; }

// The bulk path (see copy_bulk_kernel): src + head and dst + head
// 16-byte aligned, n_bulk and tile_bytes multiples of 16, head and
// nbytes - head - n_bulk under 16; grid blocks (the SMs, at most the
// tiles), each with the ring as dynamic shared memory.
int symm_copy_bulk(const void* src, void* dst, long long nbytes, long long head,
                   long long n_bulk, long long tile_bytes, int grid, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(copy_bulk_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, RING_BYTES);
  if (e != cudaSuccess) return (int)e;
  copy_bulk_kernel<<<grid, BULK_THREADS, RING_BYTES, (cudaStream_t)stream>>>(
      (const uint8_t*)src, (uint8_t*)dst, nbytes, head, n_bulk, tile_bytes);
  return (int)cudaGetLastError();
}

// The byte path: nbytes (> 0) byte by byte, grid blocks.
int symm_copy_bytes(const void* src, void* dst, long long nbytes, long long tile_bytes,
                    int grid, void* stream) {
  copy_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>((const uint8_t*)src, (uint8_t*)dst,
                                                           nbytes, tile_bytes);
  return (int)cudaGetLastError();
}

}  // extern "C"
