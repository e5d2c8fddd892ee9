// Exact k nearest neighbours, ascending, ties to the lowest index.
//
// Replaces: pointnet2_tpu/ops/pallas/knn.py:39 `_knn_kernel`
//           (reached through `knn_pallas`, knn.py:71-125, and
//           `three_nn_pallas`, knn.py:128).
//
// Semantics: for every query, the k smallest float32 difference-form squared
// distances (dx*dx + dy*dy + dz*dz, in that order) to the reference points,
// in ascending order; equal distances keep the lower reference index first,
// as a stable sort of the distance row does. Any 1 <= k <= m.
//
// What bounds it on the H100: operations, about 9 a (query, reference) pair:
// every pair is needed. The TPU kernel makes k full-width argmin passes over a
// (tile, M) distance block; here each pair is looked at once.
//
// Design, k <= 16 (`knn_kernel<K>`, the register route): S lanes of a warp
// share one query (S a power of two up to 32, from the plan in
// ops/cuda/knn.py): lane s takes points s, s+S, s+2S, ... and keeps its own
// sorted top-k in registers (K is a template parameter, so the arrays do not
// spill). Keys are the distances' bit patterns, which order as the floats do
// (d >= 0, then +inf, then NaN); a lane meets its points in index order, so
// a plain `<` on the keys inserts in (distance, index) order, with one
// compare a slot. Every 16 points the S lanes take the least of their k-th
// keys by shuffle, a bound past which no point can be among the query's k
// nearest, and skip what lies past it. At the end log2(S) butterfly steps
// (`__shfl_xor_sync` of the k pairs) merge the lanes' lists, comparing
// (key, index) in full, and keep the first k: the order is total, so every
// lane of the query ends with the same list, the stable sort's first k.
// The block stages the cloud once into shared memory with 4-byte `cp.async`
// (tiles of up to 1024 points, two buffers: the next tile loads while this
// one is scanned), laid out as three arrays (x, y, z) in which each lane's
// points lie one after the other, so a lane reads 4 of its points with one
// 16-byte load of each array; the warp's other queries read the same words
// (a broadcast), and the runs of neighbouring lanes start in different bank
// groups. The filter `key < bound` costs a compare and a branch a pair, the
// insert runs only for the few that pass.
//
// On the H100 one lane a query was the fastest at FP4 (1024 points, 8192
// queries a cloud, B=8 and 16), where the launch already has 2048 to 4096
// warps, and 4 to 8 lanes at FP2 and FP3, where one lane a query leaves
// most of the card idle (PERF.md): a lane that sees 1/S of the points takes
// more inserts into its own top-k than one that sees all of them, so the
// split pays only where the card would otherwise idle. The earlier design
// (one thread a query, three 4-byte loads a point) ran at FP4 as fast as
// this one; the 16-byte loads of 4 points are what keep the split lanes'
// strided points from costing more loads than that.
//
// Design, k > 16 (`knn_kernel_list`, the list route): one warp a query, the
// sorted list of k (distance, index) pairs in shared memory (8 bytes a pair,
// so a block of W warps needs W * k * 8 bytes: k <= 29056 with one warp). The
// warp reads the cloud 32 references at a time in index order, filters them
// against the list's current k-th pair with one `__ballot_sync`, and inserts
// the survivors one by one in lane order: the warp counts the pairs before the
// new one (its slot), shifts the tail up one slot, 32 slots at a time from the
// top, and writes it. A survivor is checked again against the k-th pair
// before its insert, since an earlier one may have pushed it out.
//
// ---------------------------------------------------------------------------
// pn2_knn_tiles: kNN through calibrated x-windows.
//
// Replaces: pointnet2_tpu/ops/pallas/knn.py:133 `_knn_sliced_kernel`
//           (launched by `knn_sliced`, knn.py:173-315).
//
// Semantics: the dataset (xs, with each column's original index in perm) and
// the queries (qs) are sorted by x; query tile t of cloud b (128 queries)
// sees the w columns [lo[b,t], lo[b,t] + w) of the sorted dataset, of which
// those at or past m are padding. Per query, the k picks in ascending
// (distance, original index) order, distances as above; with fewer than k
// finite columns the remaining picks are (+inf, the lowest original index of
// the window), which is what the TPU kernel's k min-and-remove passes give.
//
// What bounds it on the H100: operations, about 9 a (query, column) pair of
// the scan, over the columns a query's k-th distance cannot rule out. The TPU
// kernel makes k full-width passes over a (128, w) block.
//
// Design, k <= 16 (the register route): one block of 128 threads per
// (cloud, tile), one lane a query. The block stages the window in dynamic shared memory as 16-byte (x, y, z,
// original index) quads (window_bq.cuh's `stage_quads`), one 16-byte load a
// column, when it fits; else it reads the window where it lies. A query
// walks outward from its place in the x-sorted window, a cursor on each
// side; a side stops when the next column's fl(dx^2) is strictly above the
// query's current k-th distance d_k. The stop is exact: the rounded dy^2 and
// dz^2 are not negative, so a column's distance is at least its fl(dx^2),
// and along a side fl(dx^2) does not fall; a column with fl(dx^2) == d_k is
// still looked at, since it can tie d_k with a lower original index.
// Queries are x-sorted, so the 32 queries of a warp walk nearly the same
// columns: the warp walks them in step, from the place of its first query
// outward, kChunk columns of one side a step (independent 16-byte loads, the
// same address in every lane: a broadcast), each step on the side whose
// next chunk starts nearer in x to its middle query, and stops a side when
// no lane's outermost column of the chunk passes the test (`__any_sync`); on
// the right a column still left of a lane's own query keeps that lane
// going. The warp's choices are the same in every lane, so nothing diverges
// but the inserts. Columns arrive out of index order, so the top k is kept
// as 64-bit keys (distance bits << 32 | original index), one compare a slot
// for the full (distance, index) order. When the k-th pick is +inf the walk
// never stopped, so every column was seen: the +inf picks take the window's
// lowest original index, which the query then reads (a window with fewer
// than k finite columns; rare).
//
// On the H100 (PERF.md), at FP4: a walk of its own a lane, its side chosen
// by its own fl(dx^2), diverged at every step (50 / 72 us at B=8 / 16); the
// warp's walk a column a step paid its side choice, vote and prefetch on
// every column (56 / 86 us); kChunk = 8 columns a step took 30.5 / 48 us.
// Splitting a query over 2 or 4 lanes (each a share of the chunk, the bounds
// shared by shuffle) was slower (33.5 / 61.5 us with 2): a lane that sees
// fewer columns inserts more often, and the warp pays every insert; so was
// splitting a tile's queries over 2 or 4 blocks, the card already full at
// 512 / 1024 blocks. What is left is the inserts: the walk meets the columns in x
// order, so a query's top k changes about k ln(n / k) times in n columns,
// and in most chunks some lane of the warp inserts.
//
// Design, k > 16 (the list route): one block of up to 4 warps per (cloud,
// tile), each warp taking 32 of the tile's queries in turn with the list
// route above over the whole window (the window's quads, then the lists, in
// shared memory), comparing (distance, original index) lexicographically.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>

#include "window_bq.cuh"

namespace {

using pn2_window::dist2;
using pn2_window::kFull;

constexpr int kMaxRegisterK = 16;
constexpr int kThreads = 256;  // the register route's largest block
constexpr int kMaxListWarps = 8;
constexpr int kMaxShared = 232448;  // H100: 227 KB of dynamic shared memory a block
constexpr int kTileQueries = 128;
constexpr int kBatch = 16;  // references a lane scans between two refreshes of the query's bound
constexpr unsigned kEmpty = 0xffffffffu;
constexpr int kChunk = 8;  // columns of one side the windowed kNN's warp takes a step
constexpr unsigned kInfBits = 0x7f800000u;  // +inf's bit pattern
using Key = unsigned long long;  // distance bits << 32 | original index
constexpr Key kNoKey = ~0ull;

template <typename T>
__device__ __forceinline__ bool before(T d, int i, T bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

// Insert (d, j) into the sorted (bd, bi) if it sorts before the last pair.
template <int K, typename T>
__device__ __forceinline__ void insert(T (&bd)[K], int (&bi)[K], T d, int j) {
  if (!before(d, j, bd[K - 1], bi[K - 1])) return;
  // Walk down from the last slot: slot s takes slot s-1's pair when (d, j)
  // sorts before it, else (d, j) itself if (d, j) sorts before slot s.
#pragma unroll
  for (int s = K - 1; s >= 0; --s) {
    if (s > 0 && before(d, j, bd[s - 1], bi[s - 1])) {
      bd[s] = bd[s - 1];
      bi[s] = bi[s - 1];
    } else if (before(d, j, bd[s], bi[s])) {
      bd[s] = d;
      bi[s] = j;
    }
  }
}

// Insert (v, j) into the sorted (bk, bi), v known to sort before the last key
// and j larger than every index held (a lane scans in index order), so the
// plain `<` of the keys is the order by (key, index): two compares fewer a
// slot than `insert`, on the path a warp takes most often.
template <int K>
__device__ __forceinline__ void insert_scanned(unsigned (&bk)[K], int (&bi)[K], unsigned v, int j) {
  bool below[K];
#pragma unroll
  for (int s = 0; s < K; ++s) below[s] = s == K - 1 || v < bk[s];
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    bk[s] = below[s - 1] ? bk[s - 1] : (below[s] ? v : bk[s]);
    bi[s] = below[s - 1] ? bi[s - 1] : (below[s] ? j : bi[s]);
  }
  if (below[0]) {
    bk[0] = v;
    bi[0] = j;
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The floats of one lane's run in a staged tile of `tile` points with
// `lanes` lanes a query; the tile is three arrays (x, y, z) of `lanes` runs.
__host__ __device__ __forceinline__ int run_floats(int tile, int lanes) {
  // Each lane's run holds its points of the tile in order, rounded up to a
  // 16-byte multiple whose count of 16-byte words is odd: the runs of 8
  // neighbouring lanes then start in 8 different bank groups, so a 16-byte
  // load of each lane's next 4 points is conflict-free.
  const int r = ((tile + lanes - 1) / lanes + 3) / 4;
  return 4 * (r | 1);
}

// Points [t * tile, t * tile + len) of the cloud into buf: point p goes to
// lane p % lanes's run, at its place p / lanes, so that each lane reads its
// points (p = lane, lane + lanes, ...) one after the other. Every thread
// stages a share of the words.
__device__ __forceinline__ void stage(float* buf, const float* __restrict__ pts, int t, int tile,
                                      int len, int lanes_log2, int run) {
  const float* src = pts + (size_t)t * tile * 3;
  const int array = run << lanes_log2;
  const int mask = (1 << lanes_log2) - 1;
  for (int i = threadIdx.x; i < len * 3; i += blockDim.x) {
    const int p = i / 3;
    cp_async4(buf + (i - 3 * p) * array + (p & mask) * run + (p >> lanes_log2), src + i);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Grid: b * blocks_per_cloud blocks of `threads`, 2^lanes_log2 lanes a
// query, each lane every 2^lanes_log2-th point; dynamic shared memory
// min(2, tiles) staged tiles (`run_floats`).
template <int K>
__global__ void __launch_bounds__(kThreads)
    knn_kernel(const float* __restrict__ refs, const float* __restrict__ queries, int m,
               int nq, int lanes_log2, int tile, int blocks_per_cloud,
               float* __restrict__ dist, int* __restrict__ idx) {
  extern __shared__ __align__(16) float tiles[];
  const int cloud = blockIdx.x / blocks_per_cloud;
  const int lanes = 1 << lanes_log2;
  const int sub = threadIdx.x & (lanes - 1);
  const int qi = (blockIdx.x - cloud * blocks_per_cloud) * (blockDim.x >> lanes_log2) +
                 (threadIdx.x >> lanes_log2);
  // A lane past the last query scans the last one: it must take part in the shuffles.
  const float* q = queries + ((size_t)cloud * nq + min(qi, nq - 1)) * 3;
  const float qx = q[0], qy = q[1], qz = q[2];
  const float* pts = refs + (size_t)cloud * m * 3;

  // Keys are the distances' bit patterns: for d >= 0, +inf and NaN the
  // unsigned order is the float order (NaN last, as torch.sort puts it), and
  // kEmpty sorts after every distance.
  unsigned bk[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bk[s] = kEmpty;
    bi[s] = INT_MAX;
  }
  unsigned thr = kEmpty;         // a lane inserts a key below thr: below its k-th, not past the bound
  unsigned past_bound = kEmpty;  // one more than the query's bound

  const int ntiles = (m + tile - 1) / tile;
  const int run = run_floats(tile, lanes);
  const int words = 3 * (run << lanes_log2);  // a staged tile
  stage(tiles, pts, 0, tile, min(tile, m), lanes_log2, run);
  if (ntiles > 1) stage(tiles + words, pts, 1, tile, min(tile, m - tile), lanes_log2, run);
  for (int tt = 0; tt < ntiles; ++tt) {
    if (tt + 1 < ntiles) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int len = min(tile, m - tt * tile);
    const int offset = tt * tile + sub;  // the index of this lane's round 0
    const float* px = tiles + (tt & 1) * words + sub * run;
    const float* py = px + (run << lanes_log2);
    const float* pz = py + (run << lanes_log2);
    // Round r gives every lane its point r (index r * lanes + lane); the
    // query's bound is refreshed every kBatch rounds (the lanes of a warp
    // run the same rounds).
    const int rounds = (len + lanes - 1) >> lanes_log2;
    const int full = len >> lanes_log2;  // rounds in which every lane has a point
    for (int r0 = 0; r0 < rounds; r0 += kBatch) {
      if (lanes > 1) {
        // The query's bound: the least k-th key of its lanes. A point past it
        // cannot be among the k nearest (that lane holds k keys below it), so
        // a lane skips it even while its own list would take it.
        unsigned bound = bk[K - 1];
        for (int off = 1; off < lanes; off <<= 1) bound = min(bound, __shfl_xor_sync(kFull, bound, off));
        past_bound = bound == kEmpty ? kEmpty : bound + 1;
        thr = min(bk[K - 1], past_bound);
      }
      if (r0 + kBatch <= full) {
#pragma unroll
        for (int v = 0; v < kBatch; v += 4) {
          const float4 x4 = *reinterpret_cast<const float4*>(px + r0 + v);
          const float4 y4 = *reinterpret_cast<const float4*>(py + r0 + v);
          const float4 z4 = *reinterpret_cast<const float4*>(pz + r0 + v);
          const float xs[4] = {x4.x, x4.y, x4.z, x4.w};
          const float ys[4] = {y4.x, y4.y, y4.z, y4.w};
          const float zs[4] = {z4.x, z4.y, z4.z, z4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const unsigned key = __float_as_uint(dist2(qx, qy, qz, xs[u], ys[u], zs[u]));
            if (key < thr) {
              insert_scanned<K>(bk, bi, key, offset + ((r0 + v + u) << lanes_log2));
              thr = min(bk[K - 1], past_bound);
            }
          }
        }
      } else {
        for (int r = r0; r < rounds && (r << lanes_log2) + sub < len; ++r) {
          const unsigned key = __float_as_uint(dist2(qx, qy, qz, px[r], py[r], pz[r]));
          if (key < thr) {
            insert_scanned<K>(bk, bi, key, offset + (r << lanes_log2));
            thr = min(bk[K - 1], past_bound);
          }
        }
      }
    }
    __syncthreads();  // every warp is past this buffer
    if (tt + 2 < ntiles) {
      stage(tiles + (tt & 1) * words, pts, tt + 2, tile, min(tile, m - (tt + 2) * tile), lanes_log2, run);
    }
  }

  // Butterfly merge of the query's lanes: after the step of `off`, lanes that
  // differ only in bits below 2 * off hold the same list. Lanes' indices
  // interleave, so the merge compares (key, index) in full.
  for (int off = 1; off < lanes; off <<= 1) {
    unsigned ok[K];
    int oi[K];
#pragma unroll
    for (int s = 0; s < K; ++s) {
      ok[s] = __shfl_xor_sync(kFull, bk[s], off);
      oi[s] = __shfl_xor_sync(kFull, bi[s], off);
    }
#pragma unroll
    for (int s = 0; s < K; ++s) insert<K>(bk, bi, ok[s], oi[s]);
  }
  if (qi < nq) {
    const size_t row = ((size_t)cloud * nq + qi) * K;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      if ((s & (lanes - 1)) == sub) {
        dist[row + s] = __uint_as_float(bk[s]);
        idx[row + s] = bi[s];
      }
    }
  }
}

// The cloud's rows read where they lie; a reference's original index is its own.
struct RowColumns {
  const float* xyz;
  __device__ __forceinline__ void get(int j, float& cx, float& cy, float& cz, int& o) const {
    cx = xyz[3 * j + 0];
    cy = xyz[3 * j + 1];
    cz = xyz[3 * j + 2];
    o = j;
  }
};

// One warp, one query: the k smallest (distance, original index) pairs of
// columns [0, len) in the sorted list (ld, li) of shared memory, which only
// this warp touches. Returns the lowest original index among the columns.
template <class Columns>
__device__ int scan_knn_list(const Columns& cols, int len, float qx, float qy, float qz, int k,
                         int lane, float* ld, int* li) {
  for (int s = lane; s < k; s += 32) {
    ld[s] = INFINITY;
    li[s] = INT_MAX;
  }
  __syncwarp();
  int lowest = INT_MAX;
  for (int base = 0; base < len; base += 32) {
    const int j = base + lane;
    float d = INFINITY;
    int o = INT_MAX;
    if (j < len) {
      float cx, cy, cz;
      cols.get(j, cx, cy, cz, o);
      d = dist2(qx, qy, qz, cx, cy, cz);
      lowest = min(lowest, o);
    }
    unsigned pass = __ballot_sync(kFull, j < len && before(d, o, ld[k - 1], li[k - 1]));
    while (pass != 0u) {
      const int src = __ffs(pass) - 1;
      pass &= pass - 1u;
      const float vd = __shfl_sync(kFull, d, src);
      const int vo = __shfl_sync(kFull, o, src);
      if (!before(vd, vo, ld[k - 1], li[k - 1])) continue;  // pushed out since the ballot
      int below = 0;
      for (int s = lane; s < k; s += 32) below += before(ld[s], li[s], vd, vo);
      const int at = __reduce_add_sync(kFull, below);
      // Slots at .. k-2 move up one (the last pair drops out), from the top down.
      for (int hi_s = k - 1; hi_s > at; hi_s -= 32) {
        const int s = hi_s - lane;
        const bool moves = s > at;
        float md = 0.f;
        int mi = 0;
        if (moves) {
          md = ld[s - 1];
          mi = li[s - 1];
        }
        __syncwarp();
        if (moves) {
          ld[s] = md;
          li[s] = mi;
        }
        __syncwarp();
      }
      if (lane == 0) {
        ld[at] = vd;
        li[at] = vo;
      }
      __syncwarp();
    }
  }
  for (int off = 16; off > 0; off >>= 1) lowest = min(lowest, __shfl_xor_sync(kFull, lowest, off));
  return lowest;
}

// Grid: b * ceil(nq / warps) blocks of `warps` warps, one query a warp;
// dynamic shared memory warps * k * 8 bytes.
__global__ void knn_kernel_list(const float* __restrict__ refs, const float* __restrict__ queries,
                                int m, int nq, int k, int blocks_per_cloud,
                                float* __restrict__ dist, int* __restrict__ idx) {
  extern __shared__ __align__(16) float lists[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int cloud = blockIdx.x / blocks_per_cloud;
  const int qi = (blockIdx.x - cloud * blocks_per_cloud) * (blockDim.x >> 5) + warp;
  if (qi >= nq) return;  // the whole warp
  float* ld = lists + (size_t)warp * k * 2;
  int* li = reinterpret_cast<int*>(ld + k);
  const size_t row = (size_t)cloud * nq + qi;
  const float* q = queries + row * 3;
  scan_knn_list(RowColumns{refs + (size_t)cloud * m * 3}, m, q[0], q[1], q[2], k, lane, ld, li);
  for (int s = lane; s < k; s += 32) {
    dist[row * k + s] = ld[s];
    idx[row * k + s] = li[s];
  }
}

template <int K>
cudaError_t launch(const float* refs, const float* queries, int b, int m, int nq,
                   int lanes_log2, int threads, float* dist, int* idx, cudaStream_t stream) {
  const int per_block = threads >> lanes_log2;
  const int blocks_per_cloud = (nq + per_block - 1) / per_block;
  const int tile = min(1024, (m + 31) / 32 * 32);
  const size_t smem = (size_t)(m > tile ? 2 : 1) * 3 * (run_floats(tile, 1 << lanes_log2) << lanes_log2) *
                      sizeof(float);
  knn_kernel<K><<<b * blocks_per_cloud, threads, smem, stream>>>(
      refs, queries, m, nq, lanes_log2, tile, blocks_per_cloud, dist, idx);
  return cudaGetLastError();
}

cudaError_t launch_list(const float* refs, const float* queries, int b, int m, int nq, int k,
                        int threads, float* dist, int* idx, cudaStream_t stream) {
  const int warps = threads >> 5;
  const size_t smem = (size_t)warps * k * 8;
  if (smem > (size_t)kMaxShared) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn_kernel_list, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int blocks_per_cloud = (nq + warps - 1) / warps;
  knn_kernel_list<<<b * blocks_per_cloud, threads, smem, stream>>>(refs, queries, m, nq, k,
                                                                  blocks_per_cloud, dist, idx);
  return cudaGetLastError();
}

// Insert v into the ascending keys bk, v known to sort before the last.
template <int K>
__device__ __forceinline__ void insert_key(Key (&bk)[K], Key v) {
  bool below[K];
#pragma unroll
  for (int s = 0; s < K; ++s) below[s] = s == K - 1 || v < bk[s];
#pragma unroll
  for (int s = K - 1; s > 0; --s) bk[s] = below[s - 1] ? bk[s - 1] : (below[s] ? v : bk[s]);
  if (below[0]) bk[0] = v;
}

// The k-th distance's bits of a list (+inf while it holds fewer than k).
__device__ __forceinline__ unsigned kth_bits(Key last) { return min((unsigned)(last >> 32), kInfBits); }

// The walk of one warp's queries over the x-sorted columns [0, len) of
// `cols`, all lanes in step, kChunk columns of one side a step. The left side
// starts left of the warp's first query (every query of the warp lies at or
// right of it: the queries are sorted), the right side at it; each step
// takes the side whose next chunk starts nearer in x to the warp's middle
// query. A side stops once no lane's outermost column of the chunk has
// fl(dx^2) at or below its k-th distance (on the right, a column left of the
// lane's own query always goes on: there fl(dx^2) still falls). Leaves each
// lane's k smallest keys in bk.
template <int K, class Columns>
__device__ __forceinline__ void walk(const Columns& cols, int len, float qx, float qy, float qz,
                                     Key (&bk)[K]) {
  int a = 0, e = len;  // the query's place: the first column with x >= qx
  while (a < e) {
    const int mid = (a + e) >> 1;
    if (cols.xat(mid) < qx) {
      a = mid + 1;
    } else {
      e = mid;
    }
  }
  const int place = __shfl_sync(kFull, a, 0);
  const float centre = __shfl_sync(kFull, qx, 16);
  // The innermost column of each side's next chunk, and its x (the same in every lane).
  int left = place - 1, right = place;
  bool open_left = left >= 0, open_right = right < len;
  float lx = open_left ? cols.xat(left) : 0.f;
  float rx = open_right ? cols.xat(right) : 0.f;
  unsigned bound = kInfBits;  // the k-th distance's bits
  while (open_left || open_right) {
    const bool take_left = open_left && (!open_right || __fsub_rn(centre, lx) <= __fsub_rn(rx, centre));
    const int base = take_left ? left : right;
    const int dir = take_left ? -1 : 1;
    bool go = false;  // this lane's outermost column of the chunk passed: the side goes on
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int j = base + dir * i;
      if (j >= 0 && j < len) {
        const float4 v = cols.quad(j);
        const float dx = __fsub_rn(qx, v.x);
        const float dx2 = __fmul_rn(dx, dx);
        const float dy = __fsub_rn(qy, v.y);
        const float dz = __fsub_rn(qz, v.z);
        const float d = __fadd_rn(__fadd_rn(dx2, __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
        const Key key = ((Key)__float_as_uint(d) << 32) | (unsigned)__float_as_int(v.w);
        if (key < bk[K - 1]) {
          insert_key<K>(bk, key);
          bound = kth_bits(bk[K - 1]);
        }
        // Strict: a column at fl(dx^2) == d_k may still tie d_k with a lower index.
        go = __float_as_uint(dx2) <= bound || (!take_left && j < a);
      }
    }
    const bool more = __any_sync(kFull, go);
    if (take_left) {
      left -= kChunk;
      open_left = more && left >= 0;
      if (open_left) lx = cols.xat(left);
    } else {
      right += kChunk;
      open_right = more && right < len;
      if (open_right) rx = cols.xat(right);
    }
  }
}

// Grid (tiles, b). K > 0: kTileQueries threads, one a query; K = 0 (the
// list route): up to 4 warps, k pairs of 8 bytes a warp after the window. Dynamic shared memory: 16 * w bytes for the
// window's quads when `staged`, then the lists. xs (b, m, 3), perm (b, m)
// sorted; qs (b, nq, 3) sorted, nq = 128 * tiles; lo (b, tiles); dist/idx
// (b, nq, k) in sorted query order.
template <int K>
__global__ void knn_tiles_kernel(const float* __restrict__ xs, const int* __restrict__ perm,
                                 const float* __restrict__ qs, const int* __restrict__ lo, int m,
                                 int nq, int w, int k, bool staged, float* __restrict__ dist,
                                 int* __restrict__ idx) {
  extern __shared__ __align__(16) float4 window_quads[];
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int start = lo[b * gridDim.x + tile];
  const int len = max(0, min(w, m - start));  // the window's columns inside the dataset
  const pn2_window::GlobalColumns window{xs + ((size_t)b * m + start) * 3,
                                         perm + (size_t)b * m + start};
  const pn2_window::SharedQuads shared =
      staged ? pn2_window::stage_quads(window_quads, window, 0, len) : pn2_window::SharedQuads{window_quads, 0};

  if constexpr (K == 0) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    float* ld = reinterpret_cast<float*>(window_quads + (staged ? w : 0)) + (size_t)warp * k * 2;
    int* li = reinterpret_cast<int*>(ld + k);
    for (int qi = warp; qi < kTileQueries; qi += blockDim.x >> 5) {
      const size_t q = (size_t)b * nq + (size_t)tile * kTileQueries + qi;
      const float qx = qs[q * 3 + 0], qy = qs[q * 3 + 1], qz = qs[q * 3 + 2];
      const int lowest = staged ? scan_knn_list(shared, len, qx, qy, qz, k, lane, ld, li)
                                : scan_knn_list(window, len, qx, qy, qz, k, lane, ld, li);
      for (int s = lane; s < k; s += 32) {
        dist[q * k + s] = ld[s];
        idx[q * k + s] = ld[s] == INFINITY ? min(lowest, m) : li[s];
      }
      __syncwarp();  // the list is read out before the next query resets it
    }
  } else {
    const size_t q = (size_t)b * nq + (size_t)tile * kTileQueries + threadIdx.x;
    const float qx = qs[q * 3 + 0];
    const float qy = qs[q * 3 + 1];
    const float qz = qs[q * 3 + 2];
    Key bk[K];
#pragma unroll
    for (int s = 0; s < K; ++s) bk[s] = kNoKey;
    if (staged) {
      walk<K>(shared, len, qx, qy, qz, bk);
    } else {
      walk<K>(window, len, qx, qy, qz, bk);
    }
    // A +inf k-th pick: the query saw every column, and its +inf picks take
    // the lowest original index of the window (m for padding alone).
    int lowest = m;
    if (kth_bits(bk[K - 1]) == kInfBits) {
      for (int j = 0; j < len; ++j) lowest = min(lowest, staged ? __float_as_int(shared.quad(j).w) : window.orig[j]);
    }
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const unsigned bits = (unsigned)(bk[s] >> 32);
      const bool inf = bits >= kInfBits;
      dist[q * K + s] = inf ? INFINITY : __uint_as_float(bits);
      idx[q * K + s] = inf ? lowest : (int)(unsigned)bk[s];
    }
  }
}

template <int K>
cudaError_t launch_tiles(const float* xs, const int* perm, const float* qs,
                         const int* lo, int b, int m, int nq, int w, int k,
                         float* dist, int* idx, cudaStream_t stream) {
  // The list route: up to 4 warps, as many as have room for their lists.
  const int threads = K == 0 ? 32 * max(1, min(kTileQueries / 32, kMaxShared / (k * 8))) : kTileQueries;
  const size_t lists = K == 0 ? (size_t)(threads / 32) * k * 8 : 0;
  if (lists > (size_t)kMaxShared) return cudaErrorInvalidValue;
  const bool staged = (size_t)w * 16 + lists <= (size_t)kMaxShared;
  const size_t smem = (staged ? (size_t)w * 16 : 0) + lists;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn_tiles_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(nq / kTileQueries, b);
  knn_tiles_kernel<K><<<grid, threads, smem, stream>>>(xs, perm, qs, lo, m, nq, w, k, staged, dist,
                                                       idx);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// refs (b, m, 3), queries (b, nq, 3) f32 -> dist (b, nq, k) f32, idx (b, nq, k) i32.
// 1 <= k <= m. k <= 16: the register route, 2^lanes_log2 lanes a query in
// blocks of `threads` (ops/cuda/knn.py `plan`); k > 16: the list route, one
// warp a query in blocks of `threads`, threads / 32 * k * 8 bytes of shared
// memory. Returns cudaGetLastError() after the launch.
int pn2_knn(const float* refs, const float* queries, int b, int m, int nq, int k,
            int lanes_log2, int threads, float* dist, int* idx, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (k < 1 || k > m || threads < 32 || threads % 32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (k > kMaxRegisterK) {
    if (threads > 32 * kMaxListWarps) return (int)cudaErrorInvalidValue;
    return (int)launch_list(refs, queries, b, m, nq, k, threads, dist, idx, s);
  }
  if (lanes_log2 < 0 || lanes_log2 > 5 || threads > kThreads) return (int)cudaErrorInvalidValue;
  switch (k) {
#define PN2_KNN_CASE(K) \
  case K:               \
    return (int)launch<K>(refs, queries, b, m, nq, lanes_log2, threads, dist, idx, s);
    PN2_KNN_CASE(1) PN2_KNN_CASE(2) PN2_KNN_CASE(3) PN2_KNN_CASE(4)
    PN2_KNN_CASE(5) PN2_KNN_CASE(6) PN2_KNN_CASE(7) PN2_KNN_CASE(8)
    PN2_KNN_CASE(9) PN2_KNN_CASE(10) PN2_KNN_CASE(11) PN2_KNN_CASE(12)
    PN2_KNN_CASE(13) PN2_KNN_CASE(14) PN2_KNN_CASE(15) PN2_KNN_CASE(16)
#undef PN2_KNN_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The windowed kNN over x-sorted query tiles: xs (b, m, 3) f32 and perm
// (b, m) i32 the sorted dataset and its original indices, qs (b, nq, 3) f32
// the sorted queries with nq a multiple of 128, lo (b, nq / 128) i32 each
// tile's window start, w the window (staged in shared memory when it fits
// beside the lists, else read from device memory), 1 <= k -> dist (b, nq, k)
// f32, idx (b, nq, k) i32, sorted query order. k > 16 needs k * 8 bytes of
// shared memory a warp (k <= 29056).
int pn2_knn_tiles(const float* xs, const int* perm, const float* qs, const int* lo,
                  int b, int m, int nq, int w, int k, float* dist, int* idx,
                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (k < 1) return (int)cudaErrorInvalidValue;
  switch (k > kMaxRegisterK ? 0 : k) {
#define PN2_KNN_TILES_CASE(K) \
  case K:                     \
    return (int)launch_tiles<K>(xs, perm, qs, lo, b, m, nq, w, k, dist, idx, s);
    PN2_KNN_TILES_CASE(0)
    PN2_KNN_TILES_CASE(1) PN2_KNN_TILES_CASE(2) PN2_KNN_TILES_CASE(3) PN2_KNN_TILES_CASE(4)
    PN2_KNN_TILES_CASE(5) PN2_KNN_TILES_CASE(6) PN2_KNN_TILES_CASE(7) PN2_KNN_TILES_CASE(8)
    PN2_KNN_TILES_CASE(9) PN2_KNN_TILES_CASE(10) PN2_KNN_TILES_CASE(11) PN2_KNN_TILES_CASE(12)
    PN2_KNN_TILES_CASE(13) PN2_KNN_TILES_CASE(14) PN2_KNN_TILES_CASE(15) PN2_KNN_TILES_CASE(16)
#undef PN2_KNN_TILES_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* pn2_knn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

const char* pn2_knn_tiles_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
