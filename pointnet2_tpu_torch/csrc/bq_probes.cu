// The four ball-query design probes: row 2's function (the exact ball query)
// by first-k min sweeps over key rows, and row 7's function (the ball query
// over x-sorted windows) on windows cut beforehand.
//
// Replaces: tools/bq_i16_probe.py:36 `_kernel` (reached through `bq`, :69-106,
//           call :88), entry `pn2_bq_keys` (int32 keys, or int16 with i16 = 1);
//           tools/bq_fat_probe.py:53 `_kernel` (reached through `bq_fat`,
//           :97-130, call :110), entry `pn2_bq_fat` (tm = 128 or 256);
//           tools/bq_cond_probe.py:62 (row 7's `_ball_query_sliced_kernel`
//           in `make_nocond`, :22-84, and behind the `lax.cond` of
//           `make_dummycond`, :87-131) and tools/bq_sliced_decomp_probe.py:69
//           (the same kernel in `kernel_only`, :67-89), entry
//           `pn2_ball_query_precut` (with and without `fits`);
//           tools/wingather_out4d_probe.py:125 (row 8's `_bq_sliced_pos_kernel`
//           in `project_group_sliced_4d`, :72-197, on windows cut by
//           `lax.dynamic_slice`, :107-119), entry `pn2_ball_query_precut_pos`.
//
// Semantics, all (csrc/ballquery.cu's): a point is in the ball when its
// float32 difference-form squared distance ((dx*dx + dy*dy) + dz*dz, each
// step rounded) is strictly below r2, the float32 square of float32(radius).
// Per query the picks are the nsample smallest keys of the in-ball columns,
// ascending; unused slots repeat the first pick, or 0 for an empty ball; the
// count is min(#in-ball, nsample). The keys of `pn2_bq_keys` and
// `pn2_bq_fat` are the column indices (the first nsample in dataset order:
// row 2); those of `pn2_ball_query_precut` are the window columns' original
// indices, a column counting only where that index is below n (row 7).
// `pn2_ball_query_precut_pos` also gives each pick's window column (row 8:
// the TPU kernel's keys are orig * w + column, and the smallest keys are the
// smallest original indices, which are unique); a slot past the count takes
// the first pick's column, an empty ball column 0 (wingather.py:91-95).
//
// What bounds them on the H100: operations, about 9 a (query, column) pair
// that can hit (rows 2 and 7). The TPU kernels build each query's whole key
// row and extract the picks by nsample full-width min sweeps over it, and
// the TPU probes vary two things in that formulation: the keys' width
// (`pn2_bq_keys`: 32 or 16 bits) and the query tile (`pn2_bq_fat`: tm = 128
// or 256 queries sharing chunk-built keys). Each entry keeps its variable;
// the rest is designed for the card. Row 2 (csrc/ballquery.cu) computes the
// same function in about 6-7 times its operation bound, being latency-bound:
// that is the yardstick, not the bound.
//
// Design of `pn2_bq_keys` and `pn2_bq_fat`: one body, `sweep`, at one
// shape: kQ = 2 queries a warp and kV = 4 words of keys a lane (the fastest
// of the shapes measured on the H100 for both widths and for the fat
// kernel's two tiles at one grid; PERF.md §6). A block's warps take
// kQ queries each; the block stages its cloud's coordinates, as
// they lie (12 bytes a point, so a warp's 32 points at a stride of 3 words
// share no bank), in chunks of 1024 points: whole where the cloud fits
// (up to 18 chunks, 216 KB), else through a ring of 4 chunk slots refilled
// once every warp of the tile is past a slot. Chunks go by TMA bulk copies
// onto an mbarrier each, all issued at once where the cloud fits, so the
// warps start on the first chunk while the rest land; a cloud whose chunks
// are not 16-byte aligned (n % 4 != 0, or an unaligned array) goes by the
// block's own loads (the launch chooses). No key row is built: a lane holds kV words of keys a
// query in registers, covering a segment of 32 x kV columns (int32) or 64 x
// kV (int16, two keys a word, the lower column in the low half). Column j's
// key is j where it is in the ball, else n. A segment's sweep: each lane
// takes the least of its words (int16: `__vimin3_u16x2`, three words an
// instruction, then the halves), `__reduce_min_sync` gives each query's
// next pick, in dataset order, and the lane holding it clears that key (or
// half-word: `__vcmpeq2` masks it) to n and folds its words again. A
// segment ends when a sweep finds n for every query of the warp, and a
// query at nsample picks (the count is capped: row 2's early stop); the
// picks are written as found and cnt is their number. So where the TPU
// kernel made nsample full-width passes, a query here makes one pass over
// its cloud with a reduction a hit and one a segment.
//
// `pn2_bq_keys`: a block of `warps` warps, the queries it takes one tile; the
// width is the only difference between the two instances. `pn2_bq_fat`: a
// tile of tm queries is a thread-block cluster of 1 to 8 blocks that split
// them (ops/cuda/bq_probes.py `fat_plan`: the fewest waves by the card's
// residency answer, then the most blocks; 4 / 8 blocks of 16 warps at tm
// 128 / 256 on the probe shape, one grid of 256 blocks for both), and each chunk is fetched once
// for the tile: one bulk copy, issued by the cluster's blocks in turn,
// multicast to every block (`.multicast::cluster`), each block's mbarrier
// expecting exactly the bytes that land in it; the blocks' barriers are
// initialised before a cluster barrier, the ring's slots are released by a
// cluster barrier, and the cluster ends on one, after every block has
// waited for every chunk it was sent (a block whose queries are past m, or
// all done, still counts the bytes).
//
// What each limit of the design before this one became (ptxas, sm_90a):
// the key rows in shared memory, which left 7 or 14 warps a block, are
// registers: 47 / 50 registers for int32 / int16 keys, 47 for the fat
// kernel, no spill. The full-width sweeps are
// segment-wide and stop at nsample. Every query of a block reads the
// cloud from shared memory, staged once a block (once a tile for the fat
// kernel), not by three scalar loads a lane from device memory. The fat
// kernel's 64 or 32 blocks of 16 warps, four block barriers and shared
// atomics a 128-column chunk, and serial extraction are 256 blocks at the
// probe shape, no barrier a chunk where the cloud fits, and each warp's own
// sweeps.

// Design of `pn2_ball_query_precut`: the tiles kernel of window_bq.cuh (rows
// 7 and 8) on a window that lies apart, (3, w) coordinates and (w) original
// indices a (cloud, tile): `PrecutColumns` reads them, and the header's
// x-span search and scans run on it as they are. Each tile's queries are
// split over blocks of warps (row 7's plan), every warp finds its block's
// x-span and the block stages it in shared memory as 16-byte quads when the
// window fits a block's buffer, and each warp scans a query's own span. With
// a non-null `fits`, a block that reads 0 there writes the other branch's
// zeros and returns: the device-side form of `lax.cond(fits, sliced, dummy)`,
// with no host read and no second launch. `pn2_ball_query_precut_pos` is the
// same kernel with kWithPos: the scans carry each pick's window column beside
// its index (window_bq.cuh's `scan_slots` holds it in a lane's register,
// `scan_list` in the query's position row), padded as row 8 pads
// (window_bq.cuh:364, :374-378); it takes no guard.

#include <climits>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

#include "window_bq.cuh"

namespace {

namespace cg = cooperative_groups;
using pn2_window::dist2;
using pn2_window::kFull;
using pn2_window::kMaxSharedWindow;
using pn2_window::kMaxSlots;

constexpr int kMaxShared = 232448;  // H100: 227 KB of dynamic shared memory a block

// ---- pn2_bq_keys and pn2_bq_fat: key sweeps in registers over a staged cloud ----

constexpr int kPointBytes = 12;
constexpr int kChunkPoints = 1024;  // a staged chunk: 12 KB, 16-byte aligned where the cloud is
constexpr int kChunkBytes = kChunkPoints * kPointBytes;
constexpr int kMaxWholeChunks = 18;  // a cloud of up to 18432 points is staged whole (216 KB)
constexpr int kRingSlots = 4;        // past that, a ring of 4 chunks (48 KB)
constexpr int kSweepMaxWarps = 16;
constexpr int kQ = 2;  // queries a warp
constexpr int kV = 4;  // words of keys a lane

__host__ __device__ inline int sweep_chunks(int n) { return (n + kChunkPoints - 1) / kChunkPoints; }

__host__ __device__ inline int sweep_slots(int n) {
  return sweep_chunks(n) <= kMaxWholeChunks ? sweep_chunks(n) : kRingSlots;
}

// The chunk slots, then an mbarrier a slot.
__host__ __device__ inline size_t sweep_shared_bytes(int n) {
  return (size_t)sweep_slots(n) * (kChunkBytes + sizeof(uint64_t));
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

struct SweepArgs {
  const float* xyz1;  // (b, n, 3)
  const float* xyz2;  // (b, m, 3)
  int n, m;
  float r2;
  int nsample;
  int tiles;    // tiles a cloud
  int tm;       // queries a tile, split evenly over the cluster's blocks
  int cluster;  // blocks a tile (a thread-block cluster where more than 1)
  int bulk;     // stage by TMA bulk copies (else by the block's own loads)
  int* idx;     // (b, m, nsample)
  int* cnt;     // (b, m)
};

// The least of a lane's kV words of keys: int32 keys a word each, or two
// int16 keys a word folded by packed 16-bit minima (three words an
// instruction) and then the two halves.
template <bool kI16>
__device__ __forceinline__ unsigned least_key(const unsigned (&w)[kV]) {
  unsigned acc = w[0];
  if constexpr (kI16) {
#pragma unroll
    for (int v = 1; v + 1 < kV; v += 2) acc = __vimin3_u16x2(acc, w[v], w[v + 1]);
    if constexpr (kV % 2 == 0) acc = __vminu2(acc, w[kV - 1]);
    return min(acc & 0xffffu, acc >> 16);
  } else {
#pragma unroll
    for (int v = 1; v < kV; ++v) acc = min(acc, w[v]);
    return acc;
  }
}

// Sets the key `key` (held once in the warp) to the sentinel `sent`.
template <bool kI16>
__device__ __forceinline__ void clear_key(unsigned (&w)[kV], unsigned key, unsigned sent) {
#pragma unroll
  for (int v = 0; v < kV; ++v) {
    if constexpr (kI16) {
      const unsigned eq = __vcmpeq2(w[v], key * 0x10001u);  // 0xffff in the half that holds it
      w[v] = (w[v] & ~eq) | (sent * 0x10001u & eq);
    } else {
      w[v] = w[v] == key ? sent : w[v];
    }
  }
}

// One body for both entries. A block of warps takes tm / cluster queries of
// one tile, kQ a warp; the tile's cloud is staged in kChunkPoints-point
// chunks, whole where it fits (no slot reused) or through a ring of
// kRingSlots, by bulk copies (one a chunk for the whole cluster, multicast,
// issued by the blocks in turn) or by the block's own loads. A warp sweeps a
// chunk a segment at a time: each lane builds kV words of keys a query in
// registers (column j's key is j where it is in the ball, else n), then every
// round takes each query's least key over the warp (`__reduce_min_sync`),
// the next pick in dataset order; the lane holding it clears it and folds its
// words again. A segment ends when no query has a key below n left, a query
// at nsample picks (the count is capped: row 2's early stop). The picks are
// written as found; cnt is their number.
template <bool kI16>
__device__ __forceinline__ void sweep(const SweepArgs& a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int chunks = sweep_chunks(a.n);
  const int slots = sweep_slots(a.n);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + (size_t)slots * kChunkBytes);
  const int rank = (int)blockIdx.x % a.cluster;
  const int tile_id = (int)blockIdx.x / a.cluster;
  const int cloud = tile_id / a.tiles;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = (tile_id - cloud * a.tiles) * a.tm + rank * (a.tm / a.cluster) + warp * kQ;
  const float* pts = a.xyz1 + (size_t)cloud * a.n * 3;
  const unsigned sent = (unsigned)a.n;
  const uint16_t mask = (uint16_t)((1u << a.cluster) - 1u);
  const bool cluster_wide = a.bulk && a.cluster > 1;

  float qx[kQ], qy[kQ], qz[kQ];
  int picks[kQ];
  unsigned first[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int qi = q0 + q;
    const float* p = a.xyz2 + ((size_t)cloud * a.m + (qi < a.m ? qi : 0)) * 3;
    qx[q] = p[0];
    qy[q] = p[1];
    qz[q] = p[2];
    picks[q] = qi < a.m ? 0 : a.nsample;  // a query past m is done from the start
    first[q] = 0u;
  }

  auto chunk_len = [&](int c) { return min(kChunkPoints, a.n - c * kChunkPoints); };
  auto slot = [&](int c) { return reinterpret_cast<float*>(smem + (size_t)(c % slots) * kChunkBytes); };
  auto issue = [&](int c) {  // thread 0 of every block of the tile
    const uint32_t bytes = (uint32_t)chunk_len(c) * kPointBytes;
    expect_bytes(bars + c % slots, bytes);
    if (c % a.cluster == rank) bulk_load(slot(c), pts + (size_t)c * kChunkPoints * 3, bytes, bars + c % slots, mask);
  };
  auto load = [&](int c) {  // the block's own loads, then a barrier
    const float* src = pts + (size_t)c * kChunkPoints * 3;
    float* dst = slot(c);
    for (int i = threadIdx.x; i < chunk_len(c) * 3; i += blockDim.x) dst[i] = src[i];
    __syncthreads();
  };
  auto sync_tile = [&]() {  // every block of the tile is past a chunk
    if (cluster_wide) {
      cg::this_cluster().sync();
    } else {
      __syncthreads();
    }
  };

  if (a.bulk) {
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

  constexpr int kSeg = (kI16 ? 64 : 32) * kV;  // a warp's columns a segment
  for (int c = 0; c < chunks; ++c) {
    if (a.bulk) mbarrier_wait(bars + c % slots, (c / slots) & 1);  // every warp: nothing in flight at exit
    bool done = true;
#pragma unroll
    for (int q = 0; q < kQ; ++q) done = done && picks[q] >= a.nsample;
    const float* s = slot(c);
    const int len = chunk_len(c);
    const int c0 = c * kChunkPoints;
    for (int seg = 0; seg < len && !done; seg += kSeg) {
      unsigned key[kQ][kV];
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        constexpr int kCols = kI16 ? 2 : 1;
        float x[kCols], y[kCols], z[kCols];
        bool live[kCols];
#pragma unroll
        for (int h = 0; h < kCols; ++h) {
          const int j = seg + v * 32 * kCols + h * 32 + lane;
          live[h] = j < len;
          x[h] = y[h] = z[h] = 0.0f;
          if (live[h]) {
            x[h] = s[3 * j];
            y[h] = s[3 * j + 1];
            z[h] = s[3 * j + 2];
          }
        }
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          unsigned w = 0u;
#pragma unroll
          for (int h = 0; h < kCols; ++h) {
            const unsigned col = (unsigned)(c0 + seg + v * 32 * kCols + h * 32 + lane);
            const bool in = live[h] && picks[q] < a.nsample && dist2(qx[q], qy[q], qz[q], x[h], y[h], z[h]) < a.r2;
            w |= (in ? col : sent) << (16 * h);
          }
          key[q][v] = w;
        }
      }
      unsigned least[kQ];
      bool left = false;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        least[q] = least_key<kI16>(key[q]);
        left = left || least[q] < sent;
      }
      while (__any_sync(kFull, left)) {
        left = false;
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const unsigned k = __reduce_min_sync(kFull, least[q]);
          if (k >= sent) continue;  // the warp agrees: k is the same in every lane
          if (lane == 0) a.idx[((size_t)cloud * a.m + q0 + q) * a.nsample + picks[q]] = (int)k;
          if (picks[q] == 0) first[q] = k;
          if (++picks[q] < a.nsample) {
            clear_key<kI16>(key[q], k, sent);
            least[q] = least_key<kI16>(key[q]);
            left = left || least[q] < sent;
          } else {
            least[q] = sent;
            done = true;
#pragma unroll
            for (int p = 0; p < kQ; ++p) done = done && picks[p] >= a.nsample;
          }
        }
      }
    }
    if (c + slots < chunks) {  // the ring: refill this chunk's slot once the whole tile is past it
      sync_tile();
      if (a.bulk) {
        if (threadIdx.x == 0) issue(c + slots);
      } else {
        load(c + slots);
      }
    }
  }
  if (cluster_wide) cg::this_cluster().sync();  // no block leaves before its peers' copies are done

#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int qi = q0 + q;
    if (qi >= a.m) break;
    const size_t at = (size_t)cloud * a.m + qi;
    for (int s = picks[q] + lane; s < a.nsample; s += 32) a.idx[at * a.nsample + s] = (int)first[q];
    if (lane == 0) a.cnt[at] = picks[q];
  }
}

template <bool kI16>
__global__ void __launch_bounds__(kSweepMaxWarps * 32) bq_keys_kernel(SweepArgs a) {
  sweep<kI16>(a);
}

__global__ void __launch_bounds__(kSweepMaxWarps * 32) bq_fat_kernel(SweepArgs a) { sweep<false>(a); }

using SweepKernel = void (*)(SweepArgs);

cudaLaunchConfig_t sweep_config(cudaLaunchAttribute* attr, int blocks, int cluster, int warps, size_t smem,
                                cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3((unsigned)warps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Checks a sweep launch's shape; sets the kernel's shared memory past 48 KB.
cudaError_t sweep_prepare(SweepKernel kernel, int b, int n, int m, int nsample, int tm, int cluster,
                          size_t* smem) {
  *smem = sweep_shared_bytes(n);
  if (b < 1 || b > 65535 || n < 1 || m < 1 || nsample < 1 || tm < 1 ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) || tm % (cluster * kQ) ||
      tm / (cluster * kQ) > kSweepMaxWarps || *smem > (size_t)kMaxShared ||
      (long long)b * ((m + tm - 1) / tm) * cluster > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (*smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

// Bulk copies where every chunk is 16-byte aligned (the array and n % 4 ==
// 0), else the block's own loads.
cudaError_t launch_sweep(SweepKernel kernel, const float* xyz1, const float* xyz2, int b, int n, int m,
                         float r2, int nsample, int tm, int cluster, int* idx, int* cnt, cudaStream_t stream) {
  size_t smem = 0;
  cudaError_t err = sweep_prepare(kernel, b, n, m, nsample, tm, cluster, &smem);
  if (err != cudaSuccess) return err;
  const int bulk = reinterpret_cast<uintptr_t>(xyz1) % 16 == 0 && n % 4 == 0;
  const int tiles = (m + tm - 1) / tm;
  const SweepArgs args{xyz1, xyz2, n, m, r2, nsample, tiles, tm, cluster, bulk, idx, cnt};
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = sweep_config(&attr, b * tiles * cluster, cluster, tm / (cluster * kQ), smem, stream);
  err = cudaLaunchKernelEx(&cfg, kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---- pn2_ball_query_precut ------------------------------------------------

// One (cloud, tile)'s cut window: coordinates (3, w), a row each of x, y and
// z, and each column's original index. A column whose index is not below n
// is never in the ball (the TPU kernel's `keys_orig < n`): its y reads +inf,
// which leaves the x order, and so the x-span search, as it is.
struct PrecutColumns {
  const float* win;
  const int* orig;
  int w;
  int n;
  __device__ __forceinline__ float xat(int j) const { return win[j]; }
  __device__ __forceinline__ void get(int j, float& cx, float& cy, float& cz, int& o) const {
    o = orig[j];
    cx = win[j];
    cy = o < n ? win[w + j] : INFINITY;
    cz = win[2 * w + j];
  }
  __device__ __forceinline__ float4 quad(int j) const {
    float cx, cy, cz;
    int o;
    get(j, cx, cy, cz, o);
    return make_float4(cx, cy, cz, __int_as_float(o));
  }
};

// Grid (t * split, b), `warps` warps a block; 16 * w bytes of dynamic shared
// memory when `staged` (w <= kMaxSharedWindow), else none. win (b, t, 3, w),
// permw (b, t, w), q_tiles (b, t, tm, 3) sorted by x within each tile; fits
// null or one int; idx (and with kWithPos pos) (b, t, tm, nsample), cnt (b,
// t, tm). Block (tile, part) takes queries [part * tm / split, (part + 1) *
// tm / split) of the tile. kSlots: nsample <= 32, the list in registers; else
// in the output rows.
template <bool kWithPos, bool kSlots>
__global__ void ball_query_precut_kernel(const float* __restrict__ win, const int* __restrict__ permw,
                                         const float* __restrict__ q_tiles, const int* __restrict__ fits,
                                         int t, int tm, int w, int n, int split, bool staged,
                                         float r2, int nsample, int* __restrict__ idx,
                                         int* __restrict__ pos, int* __restrict__ cnt) {
  extern __shared__ float4 quads[];
  const int tile = blockIdx.x / split;
  const int part = blockIdx.x - tile * split;
  const size_t bt = (size_t)blockIdx.y * t + tile;
  const int per_block = tm / split;
  const size_t q0 = bt * tm + (size_t)part * per_block;
  if (fits != nullptr && *fits == 0) {  // the guard's other branch
    for (int i = threadIdx.x; i < per_block * nsample; i += blockDim.x) {
      idx[q0 * nsample + i] = 0;
      if (kWithPos) pos[q0 * nsample + i] = 0;
    }
    for (int i = threadIdx.x; i < per_block; i += blockDim.x) cnt[q0 + i] = 0;
    return;
  }
  const PrecutColumns window{win + bt * 3 * w, permw + bt * w, w, n};
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;

  const int2 span =
      pn2_window::x_span(window, 0, w, q_tiles[q0 * 3], q_tiles[(q0 + per_block - 1) * 3], r2, lane);
  const pn2_window::SharedQuads shared{quads, span.x};
  if (staged) {
    for (int j = span.x + threadIdx.x; j < span.y; j += blockDim.x) quads[j - span.x] = window.quad(j);
    __syncthreads();
  }

  for (int qi = warp; qi < per_block; qi += warps) {
    const size_t q = q0 + qi;
    const float qx = q_tiles[q * 3 + 0];
    const float qy = q_tiles[q * 3 + 1];
    const float qz = q_tiles[q * 3 + 2];
    const int2 cols = staged ? pn2_window::x_span(shared, span.x, span.y, qx, qx, r2, lane)
                             : pn2_window::x_span(window, span.x, span.y, qx, qx, r2, lane);
    int c;
    if constexpr (kSlots) {
      int key, col, count;
      if (staged) {
        pn2_window::scan_slots(shared, cols.x, cols.y, qx, qy, qz, r2, nsample, lane, key, col, count);
      } else {
        pn2_window::scan_slots(window, cols.x, cols.y, qx, qy, qz, r2, nsample, lane, key, col, count);
      }
      c = count < nsample ? count : nsample;
      const int first_key = __shfl_sync(kFull, key, 0);
      const int first_col = kWithPos ? __shfl_sync(kFull, col, 0) : 0;
      if (lane < nsample) {
        const bool used = lane < c;
        idx[q * nsample + lane] = used ? key : (c > 0 ? first_key : 0);
        if (kWithPos) pos[q * nsample + lane] = used ? col : (c > 0 ? first_col : 0);
      }
    } else {
      int* out = idx + q * nsample;
      int* out_pos = kWithPos ? pos + q * nsample : nullptr;
      const int count =
          staged ? pn2_window::scan_list<pn2_window::SharedQuads, kWithPos>(shared, cols.x, cols.y, qx, qy, qz, r2,
                                                                            nsample, lane, out, out_pos)
                 : pn2_window::scan_list<PrecutColumns, kWithPos>(window, cols.x, cols.y, qx, qy, qz, r2, nsample,
                                                                  lane, out, out_pos);
      c = count < nsample ? count : nsample;
      const int first_key = c > 0 ? out[0] : 0;
      const int first_col = kWithPos && c > 0 ? out_pos[0] : 0;
      __syncwarp();
      for (int s = c + lane; s < nsample; s += 32) {
        out[s] = first_key;
        if (kWithPos) out_pos[s] = first_col;
      }
    }
    if (lane == 0) cnt[q] = c;
  }
}

template <bool kWithPos>
cudaError_t launch_precut(const float* win, const int* permw, const float* q_tiles, const int* fits,
                          int b, int t, int tm, int w, int n, float r2, int nsample, int split,
                          int warps, int* idx, int* pos, int* cnt, cudaStream_t stream) {
  if (b < 1 || b > 65535 || t < 1 || tm < 1 || w < 1 || n < 1 || nsample < 1 || split < 1 ||
      tm % split || warps < 1 || warps > 32 || (long long)t * split > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const bool staged = w <= kMaxSharedWindow;
  const size_t smem = staged ? (size_t)w * 16 : 0;
  auto* kernel = nsample <= kMaxSlots ? &ball_query_precut_kernel<kWithPos, true>
                                      : &ball_query_precut_kernel<kWithPos, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)(t * split), (unsigned)b);
  kernel<<<grid, warps * 32, smem, stream>>>(win, permw, q_tiles, fits, t, tm, w, n, split, staged, r2,
                                             nsample, idx, pos, cnt);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// xyz1 (b, n, 3), xyz2 (b, m, 3) f32 -> idx (b, m, nsample), cnt (b, m) i32:
// row 2's function by first-k sweeps over int32 keys (i16 = 0) or int16 keys
// (i16 = 1, n <= 32767), in registers. Blocks of `warps` (1 to 16) warps, 2
// queries a warp; each block stages its cloud (by TMA bulk copies where
// xyz1 is 16-byte aligned and n % 4 == 0). b <= 65535. Returns
// cudaGetLastError() after the launch.
int pn2_bq_keys(const float* xyz1, const float* xyz2, int b, int n, int m, float r2, int nsample,
                int i16, int warps, int* idx, int* cnt, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (i16 && n > 32767) return (int)cudaErrorInvalidValue;
  const SweepKernel kernel = i16 ? &bq_keys_kernel<true> : &bq_keys_kernel<false>;
  return (int)launch_sweep(kernel, xyz1, xyz2, b, n, m, r2, nsample, warps * kQ, 1, idx, cnt,
                           (cudaStream_t)stream);
}

// The same function over int32 keys, a tile of tm queries a cluster of
// `cluster` blocks (1, 2, 4 or 8; tm / (cluster * 2) warps a block, at most
// 16), each chunk of the cloud fetched once for the tile and, where bulk
// copies stage it, multicast to every block. Same other arguments as
// pn2_bq_keys.
int pn2_bq_fat(const float* xyz1, const float* xyz2, int b, int n, int m, float r2, int nsample,
               int tm, int cluster, int* idx, int* cnt, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_sweep(&bq_fat_kernel, xyz1, xyz2, b, n, m, r2, nsample, tm, cluster, idx, cnt,
                           (cudaStream_t)stream);
}

// How many clusters of pn2_bq_fat's launch (n points, tm, cluster) the card
// holds at once (cudaOccupancyMaxActiveClusters), into *out.
int pn2_bq_fat_active(int n, int tm, int cluster, int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  size_t smem = 0;
  err = sweep_prepare(&bq_fat_kernel, 1, n, tm, 1, tm, cluster, &smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = sweep_config(&attr, cluster, cluster, tm / (cluster * kQ), smem, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(out, &bq_fat_kernel, &cfg);
}

// win (b, t, 3, w) f32 and permw (b, t, w) i32: each tile's cut window of the
// x-sorted cloud (coordinates, original indices); q_tiles (b, t, tm, 3) f32
// sorted by x; fits null, or one i32 on the device (0: every output is 0) ->
// idx (b, t, tm, nsample), cnt (b, t, tm) i32: row 7's function on the cut
// windows. `split` blocks a tile (tm % split == 0) of `warps` warps (1 to 32).
// Returns cudaGetLastError() after the launch.
int pn2_ball_query_precut(const float* win, const int* permw, const float* q_tiles, const int* fits,
                          int b, int t, int tm, int w, int n, float r2, int nsample, int split,
                          int warps, int* idx, int* cnt, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_precut<false>(win, permw, q_tiles, fits, b, t, tm, w, n, r2, nsample, split, warps,
                                   idx, nullptr, cnt, (cudaStream_t)stream);
}

// The same windows and queries -> idx, pos (b, t, tm, nsample), cnt (b, t,
// tm) i32: row 8's function on the cut windows, pos each pick's window
// column (a slot past the count the first pick's, 0 for an empty ball). No
// guard. Same limits as pn2_ball_query_precut.
int pn2_ball_query_precut_pos(const float* win, const int* permw, const float* q_tiles, int b, int t, int tm,
                              int w, int n, float r2, int nsample, int split, int warps, int* idx, int* pos,
                              int* cnt, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_precut<true>(win, permw, q_tiles, nullptr, b, t, tm, w, n, r2, nsample, split, warps,
                                  idx, pos, cnt, (cudaStream_t)stream);
}

const char* pn2_bq_keys_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

const char* pn2_bq_fat_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

const char* pn2_bq_fat_active_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

const char* pn2_ball_query_precut_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

const char* pn2_ball_query_precut_pos_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
