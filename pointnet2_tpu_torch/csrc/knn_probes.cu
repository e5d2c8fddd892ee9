// The two kNN design probes: exact k nearest neighbours, each query's
// distances swept in registers a segment at a time over a staged cloud and
// merged into a running top-k list.
//
// Replaces: tools/knn_variant_probe.py:32 `_knn_kernel_v1` (reached through
//           `knn_pallas_v1`, :58-92, call :76), entry `pn2_knn_argmin`;
//           tools/knn_variant_probe.py:95 `_knn_kernel_v3` (reached through
//           `knn_pallas_v3`, :135-169, call :153), entry `pn2_knn_tracked`.
//
// Semantics, both: for every query, the k smallest float32 difference-form
// squared distances ((dx*dx + dy*dy) + dz*dz, in that order, each step
// rounded) to the cloud's references, ascending, with their indices; equal
// distances go to the lowest index first, as a stable sort of the row does.
// 1 <= k <= min(m, 32).
//
// What bounds it on the H100: operations, about 9 a (query, reference) pair
// for the distances (row 3's bound, csrc/knn.cu). The TPU kernels build each
// query's whole distance row in VMEM and make k full-width selection passes
// over it; the probes vary the pass: v1 a min reduction, then a second one
// for the lowest column holding the min (`pn2_knn_argmin`); v3 one reduction
// over (value, column) candidates that each lane tracks (`pn2_knn_tracked`).
// Each entry keeps its pass; the rest is designed for the card.
//
// Design, one body `knn_sweep<kTracked>` at one shape: kQ = 4 queries a warp
// and kV = 4 words of keys a lane, the fastest of six shapes over both
// kernels at the probe shape and at SA1's k = 32 on the H100 (PERF.md §6;
// the plan, ops/cuda/probes.py `knn_plan`, gives 8 or 16 warps a block by
// how many staged clouds fit an SM). A block of warps stages its cloud once
// (probe_stage.cuh, shared with bq_probes.cu: 1024-point chunks as they lie,
// whole up to 18432 points, else a ring of 4 slots; TMA bulk copies where
// the cloud is 16-byte aligned and m % 4 == 0, else the block's own loads).
// No row is built. A query's keys are its distances' bit patterns, which
// order as the non-negative floats and +inf do; kNone (UINT_MAX) orders above
// them all. A lane holds kV words of keys a query, column seg + v * 32 + lane
// in word v, so its words are in column order. Each query keeps its k picks
// as (key, column) pairs sorted ascending, lane p holding pick p, and its
// threshold tau, the k-th key, kNone until the list holds k picks.
// - A segment's keys are built against tau: a key is clamped to tau, which
//   no pass admits, so a segment whose warp finds no key below any query's
//   tau costs one `__any_sync` and no pass (most segments past the first
//   few). A column past the cloud's last point reads +inf coordinates: a
//   key of +inf, whose column lies past every real one, so it is never
//   picked while k real columns are left (k <= m).
// - While the query has a key below its tau (a vote), a pass takes its
//   least (key, column): v1 by `__reduce_min_sync` of each lane's least key,
//   then a second `__reduce_min_sync` of each lane's first column holding it;
//   v3 by one 64-bit (key, column) butterfly over each lane's candidate: its
//   least key and the first of its words holding it, what a strict `<` fold
//   over its words in column order keeps (its column is found only when a
//   pass runs, not at every fold).
// - The insert: position = the list entries with key <= the new key
//   (`__ballot_sync` + `__popc`); lanes at or past it shift up one
//   (`__shfl_up_sync`), pick k falls off, tau is read again from lane k - 1;
//   the lane that held the pick clears its word to kNone and folds again.
// - Every loop around a warp shuffle is led by a vote, so the compiler knows
//   the warp converged there: a test on a shuffled value instead made it
//   lower each shuffle and vote to a collective loop (WARPSYNC and
//   ENDCOLLECTIVE around every one in the SASS).
// Why this is exact: (1) segments are visited in column order; (2) within a
// segment, passes take keys in ascending (key, column) order; so (3) a new
// pick's column is above that of every list entry with an equal key, and
// inserting it after the equals keeps the stable sort's order. A key equal to
// tau therefore ranks after the k-th pick, and a strict `<` against tau is
// the whole admission rule. Queries past nq start with tau = 0 (nothing
// admitted), and their warps still wait on every chunk the block was sent.
//
// What each limit of the design before this one became (ptxas, sm_90a: 62
// registers for `knn_argmin_kernel`, 63 for `knn_tracked_kernel`, no spill;
// 32 each before): the distance row of M floats a warp in shared memory (4
// warps a block at M = 8192, one block an SM; M <= 14528) is gone: a block
// holds only its staged cloud, 16 warps of two blocks an SM at M = 8192, M
// is bounded by int32 indexing alone, and k <= 32 stays (a pick a lane).
// The k full-width passes (2k sweeps of the row for v1) are passes over one
// segment's registers, made only while a key beats tau: on a random cloud
// about k * H(M / 128) a query (H the harmonic number: 8 at k = 3 over 1024
// references, 152 at k = 32 over 8192) against the k * M / 32 reads a lane
// made before. The
// cloud, staged by 4-byte `cp.async` into three arrays, goes by bulk copies
// as it lies. What bounds them now is issue: the distances (about 10
// instructions a pair, a segment's 3 shared loads a column shared by its 4
// queries) and the passes, where v3's butterfly (two shuffles, two compares
// and two selects a step) costs more than v1's two `redux.sync`: v3 takes
// 1.3-1.5 x v1's time (PERF.md §6).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

#include "probe_stage.cuh"
#include "window_bq.cuh"

namespace {

using pn2_stage::kChunkPoints;
using pn2_window::dist2;
using pn2_window::kFull;

constexpr int kMaxK = 32;  // a pick a lane
constexpr int kMaxWarps = 16;
constexpr int kQ = 4;          // queries a warp
constexpr int kV = 4;          // words of keys a lane
constexpr int kSeg = 32 * kV;  // a warp's columns a segment
constexpr unsigned kNone = UINT_MAX;

struct KnnArgs {
  const float* refs;     // (b, m, 3)
  const float* queries;  // (b, nq, 3)
  int m, nq, k;
  int bulk;     // stage by TMA bulk copies (else by the block's own loads)
  float* dist;  // (b, nq, k)
  int* idx;     // (b, nq, k)
};

// A lane's least key over its words.
__device__ __forceinline__ unsigned fold(const unsigned (&w)[kV]) {
  unsigned least = w[0];
#pragma unroll
  for (int v = 1; v < kV; ++v) least = min(least, w[v]);
  return least;
}

// The column of a lane's first word holding `key` (kNone if none does).
__device__ __forceinline__ unsigned first_column(const unsigned (&w)[kV], unsigned key, unsigned base) {
  unsigned first = kNone;
#pragma unroll
  for (int v = kV - 1; v >= 0; --v) first = w[v] == key ? base + 32u * v : first;
  return first;
}

// Grid (ceil(nq / (warps * kQ)), b) blocks of `warps` warps; dynamic shared
// memory pn2_stage::stage_shared_bytes(m).
template <bool kTracked>
__device__ __forceinline__ void knn_sweep(const KnnArgs& a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int cloud = blockIdx.y;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = ((int)blockIdx.x * warps + warp) * kQ;
  const pn2_stage::Stage stage(smem, a.refs + (size_t)cloud * a.m * 3, a.m, a.bulk);

  float qx[kQ], qy[kQ], qz[kQ];
  unsigned lkey[kQ], lcol[kQ], tau[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int qi = q0 + q;
    const float* p = a.queries + ((size_t)cloud * a.nq + (qi < a.nq ? qi : 0)) * 3;
    qx[q] = p[0];
    qy[q] = p[1];
    qz[q] = p[2];
    lkey[q] = kNone;
    lcol[q] = 0u;
    tau[q] = qi < a.nq ? kNone : 0u;  // a query past nq admits nothing
  }

  auto sync_block = []() { __syncthreads(); };
  stage.begin(sync_block);
  for (int c = 0; c < stage.chunks; ++c) {
    stage.wait(c);  // every warp: nothing in flight at exit
    const float* s = stage.slot(c);
    const int len = stage.len(c);
    for (int seg = 0; seg < len; seg += kSeg) {
      const unsigned base = (unsigned)(c * kChunkPoints + seg + lane);  // word v: column base + 32 v
      unsigned w[kQ][kV];
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        const int j = seg + v * 32 + lane;
        float x = INFINITY, y = INFINITY, z = INFINITY;  // past the cloud's last point: a key of +inf
        if (j < len) {
          x = s[3 * j];
          y = s[3 * j + 1];
          z = s[3 * j + 2];
        }
#pragma unroll
        for (int q = 0; q < kQ; ++q) w[q][v] = min(__float_as_uint(dist2(qx[q], qy[q], qz[q], x, y, z)), tau[q]);
      }
      unsigned least[kQ];
      bool pending = false;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        least[q] = fold(w[q]);
        pending = pending || least[q] < tau[q];
      }
      if (!__any_sync(kFull, pending)) continue;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        // Every branch around a shuffle is on a vote, so the compiler sees
        // the warp converged and lowers no shuffle to a collective loop.
        while (__any_sync(kFull, least[q] < tau[q])) {
          unsigned key, col;
          if constexpr (kTracked) {
            unsigned long long pair = (unsigned long long)least[q] << 32 | first_column(w[q], least[q], base);
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
              const unsigned long long other = __shfl_xor_sync(kFull, pair, off);
              pair = other < pair ? other : pair;
            }
            key = (unsigned)(pair >> 32);
            col = (unsigned)pair;
          } else {
            key = __reduce_min_sync(kFull, least[q]);
            col = __reduce_min_sync(kFull, first_column(w[q], key, base));
          }
          const int pos = __popc(__ballot_sync(kFull, lane < a.k && lkey[q] <= key));
          const unsigned up_key = __shfl_up_sync(kFull, lkey[q], 1);
          const unsigned up_col = __shfl_up_sync(kFull, lcol[q], 1);
          lkey[q] = lane > pos ? up_key : lane == pos ? key : lkey[q];
          lcol[q] = lane > pos ? up_col : lane == pos ? col : lcol[q];
          tau[q] = __shfl_sync(kFull, lkey[q], a.k - 1);
#pragma unroll
          for (int v = 0; v < kV; ++v) w[q][v] = base + 32u * v == col ? kNone : w[q][v];
          least[q] = fold(w[q]);
        }
      }
    }
    stage.refill(c, sync_block);
  }

#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int qi = q0 + q;
    if (qi < a.nq && lane < a.k) {
      const size_t at = ((size_t)cloud * a.nq + qi) * a.k + lane;
      a.dist[at] = __uint_as_float(lkey[q]);
      a.idx[at] = (int)lcol[q];
    }
  }
}

__global__ void __launch_bounds__(kMaxWarps * 32) knn_argmin_kernel(KnnArgs a) { knn_sweep<false>(a); }

__global__ void __launch_bounds__(kMaxWarps * 32) knn_tracked_kernel(KnnArgs a) { knn_sweep<true>(a); }

// Bulk copies where every chunk is 16-byte aligned (the array and m % 4 ==
// 0), else the block's own loads.
template <auto kKernel>
cudaError_t launch(const float* refs, const float* queries, int b, int m, int nq, int k, int warps, float* dist,
                   int* idx, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t smem = pn2_stage::stage_shared_bytes(m);
  if (k < 1 || k > kMaxK || k > m || b < 1 || b > 65535 || nq < 1 || warps < 1 || warps > kMaxWarps)
    return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int bulk = reinterpret_cast<uintptr_t>(refs) % 16 == 0 && m % 4 == 0;
  const int per_block = warps * kQ;
  const dim3 grid((unsigned)((nq + per_block - 1) / per_block), (unsigned)b);
  kKernel<<<grid, warps * 32, smem, (cudaStream_t)stream>>>(KnnArgs{refs, queries, m, nq, k, bulk, dist, idx});
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// refs (b, m, 3), queries (b, nq, 3) f32 -> dist (b, nq, k) f32, idx (b, nq,
// k) i32, v1's passes (min, then the lowest column holding it). Blocks of
// `warps` warps (1 to 16), 4 queries a warp; each block stages its cloud (by
// TMA bulk copies where refs is 16-byte aligned and m % 4 == 0). 1 <= k <=
// min(m, 32); b <= 65535. Returns cudaGetLastError() after the launch.
int pn2_knn_argmin(const float* refs, const float* queries, int b, int m, int nq, int k, int warps, float* dist,
                   int* idx, int device, void* stream) {
  return (int)launch<knn_argmin_kernel>(refs, queries, b, m, nq, k, warps, dist, idx, device, stream);
}

// The same function with v3's passes (one (value, column) reduction). Same
// arguments and limits.
int pn2_knn_tracked(const float* refs, const float* queries, int b, int m, int nq, int k, int warps, float* dist,
                    int* idx, int device, void* stream) {
  return (int)launch<knn_tracked_kernel>(refs, queries, b, m, nq, k, warps, dist, idx, device, stream);
}

const char* pn2_knn_argmin_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

const char* pn2_knn_tracked_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
