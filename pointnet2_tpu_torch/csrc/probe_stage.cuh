// A probe kernel's cloud staged in its block's shared memory, shared by the
// sweeps of bq_probes.cu (`sweep`, P5 and P6) and knn_probes.cu
// (`knn_sweep`, P3 and P4).
//
// The cloud (n, 3) float32 is staged as it lies, 12 bytes a point, so a
// warp's 32 points at a stride of 3 words share no bank, in chunks of
// kChunkPoints points: whole where it fits (up to kMaxWholeChunks chunks,
// 216 KB, no slot reused), else through a ring of kRingSlots chunk slots, a
// slot refilled once every warp of the tile is past it. Chunks go by TMA bulk
// copies onto an mbarrier a slot, all issued at once where the cloud fits, so
// the warps start on the first chunk while the rest land; in a thread-block
// cluster one copy a chunk, issued by the blocks in turn, is multicast to
// every block, each block's barrier expecting exactly the bytes that land in
// it. Where the chunks are not 16-byte aligned (n % 4 != 0, or an unaligned
// array) the block stages them by its own loads. Every thread waits on every
// chunk, so no copy is in flight when a block exits.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace pn2_stage {

constexpr int kPointBytes = 12;
constexpr int kChunkPoints = 1024;  // a staged chunk: 12 KB, 16-byte aligned where the cloud is
constexpr int kChunkBytes = kChunkPoints * kPointBytes;
constexpr int kMaxWholeChunks = 18;  // a cloud of up to 18432 points is staged whole (216 KB)
constexpr int kRingSlots = 4;        // past that, a ring of 4 chunks (48 KB)

__host__ __device__ inline int stage_chunks(int n) { return (n + kChunkPoints - 1) / kChunkPoints; }

__host__ __device__ inline int stage_slots(int n) {
  return stage_chunks(n) <= kMaxWholeChunks ? stage_chunks(n) : kRingSlots;
}

// The chunk slots, then an mbarrier a slot.
__host__ __device__ inline size_t stage_shared_bytes(int n) {
  return (size_t)stage_slots(n) * (kChunkBytes + sizeof(uint64_t));
}

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbarrier_init(uint64_t* bar) {  // one arrival a phase: thread 0's
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(shared_address(bar)), "r"(1) : "memory");
}

__device__ __forceinline__ void mbarrier_wait(uint64_t* bar, int parity) {
  const uint32_t addr = shared_address(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// Thread 0's arrival on its block's `bar`, which is told to expect `bytes`
// (a peer's multicast may complete some of them first: the phase waits for
// both).
__device__ __forceinline__ void expect_bytes(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(shared_address(bar)), "r"(bytes)
               : "memory");
}

// One TMA bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device memory into this block's shared memory, completing on
// `bar`; with a `mask` of more than one block, into the same place of every
// block of the cluster in it, each completing on its own `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar,
                                          uint16_t mask) {
  if (mask == 1) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
                     shared_address(dst)),
                 "l"(src), "r"(bytes), "r"(shared_address(bar))
                 : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster [%0], [%1], %2, [%3], "
        "%4;" ::"r"(shared_address(dst)),
        "l"(src), "r"(bytes), "r"(shared_address(bar)), "h"(mask)
        : "memory");
  }
}

// One block's staged cloud in `smem` (stage_shared_bytes(n) bytes): `rank`
// of the `cluster` blocks of its tile (0 of 1 alone), `mask` those blocks.
// The steps, each called by every thread of the block:
//   begin(sync_tile): the barriers set, the first min(slots, chunks) chunks
//     issued or loaded;
//   wait(c): chunk c has landed (`slot(c)` holds its `len(c)` points);
//   refill(c, sync_tile): once the whole tile is past chunk c, its ring slot
//     takes chunk c + slots, if there is one.
// `sync_tile` is a barrier over the tile's blocks (`__syncthreads` alone).
struct Stage {
  unsigned char* smem;
  uint64_t* bars;
  const float* pts;  // the cloud, (n, 3)
  int n, chunks, slots;
  int bulk;  // not a bool: a bool member cost bq_probes.cu's sweep kernels a register
  int rank, cluster;
  uint16_t mask;

  __device__ __forceinline__ Stage(unsigned char* smem_, const float* pts_, int n_, int bulk_, int rank_ = 0,
                                   int cluster_ = 1)
      : smem(smem_),
        pts(pts_),
        n(n_),
        chunks(stage_chunks(n_)),
        slots(stage_slots(n_)),
        bulk(bulk_),
        rank(rank_),
        cluster(cluster_),
        mask((uint16_t)((1u << cluster_) - 1u)) {
    bars = reinterpret_cast<uint64_t*>(smem + (size_t)slots * kChunkBytes);
  }

  __device__ __forceinline__ int len(int c) const { return min(kChunkPoints, n - c * kChunkPoints); }

  __device__ __forceinline__ float* slot(int c) const {
    return reinterpret_cast<float*>(smem + (size_t)(c % slots) * kChunkBytes);
  }

  __device__ __forceinline__ void issue(int c) const {  // thread 0 of every block of the tile
    const uint32_t bytes = (uint32_t)len(c) * kPointBytes;
    expect_bytes(bars + c % slots, bytes);
    if (c % cluster == rank) bulk_load(slot(c), pts + (size_t)c * kChunkPoints * 3, bytes, bars + c % slots, mask);
  }

  __device__ __forceinline__ void load(int c) const {  // the block's own loads, then a barrier
    const float* src = pts + (size_t)c * kChunkPoints * 3;
    float* dst = slot(c);
    for (int i = threadIdx.x; i < len(c) * 3; i += blockDim.x) dst[i] = src[i];
    __syncthreads();
  }

  template <class Sync>
  __device__ __forceinline__ void begin(Sync sync_tile) const {
    if (bulk) {
      if (threadIdx.x == 0) {
        for (int s = 0; s < slots; ++s) mbarrier_init(bars + s);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      }
      sync_tile();  // every barrier of the cluster is set before any copy lands on one
      if (threadIdx.x == 0) {
        for (int c = 0; c < min(slots, chunks); ++c) issue(c);
      }
    } else {
      for (int c = 0; c < min(slots, chunks); ++c) load(c);
    }
  }

  __device__ __forceinline__ void wait(int c) const {
    if (bulk) mbarrier_wait(bars + c % slots, (c / slots) & 1);
  }

  template <class Sync>
  __device__ __forceinline__ void refill(int c, Sync sync_tile) const {
    if (c + slots < chunks) {  // the ring: refill this chunk's slot once the whole tile is past it
      sync_tile();
      if (bulk) {
        if (threadIdx.x == 0) issue(c + slots);
      } else {
        load(c + slots);
      }
    }
  }
};

}  // namespace pn2_stage
