// Ball-query scans shared by ballquery.cu, wingather.cu and knn.cu: the
// windowed scan of one query over x-sorted columns, the x-span search that
// bounds it, the 16-byte staging of columns, and the two kernels built from
// them over tiles of x-sorted queries.
//
// Replaces: pointnet2_tpu/ops/pallas/ballquery.py:247 `_ball_query_sliced_kernel`
//           and pointnet2_tpu/ops/pallas/wingather.py:54 `_bq_sliced_pos_kernel`
//           (`ball_query_tiles_kernel`, entries `pn2_ball_query_tiles` and
//           `pn2_ball_query_tiles_pos`);
//           pointnet2_tpu/ops/pallas/ballquery.py:80 `_ball_query_window_kernel`
//           with its wrapper's fallback, ballquery.py:131-244
//           (`ball_query_windowed_kernel`, entry `pn2_ball_query_windowed`).
//
// Semantics: the cloud (xs, with each column's original index in perm) and
// the queries (qs) are sorted by x. Query tile t of cloud b (tm queries) sees
// the w columns [lo[b,t], lo[b,t] + w) of the sorted cloud. A column is in
// the ball when its float32 difference-form squared distance (dx*dx + dy*dy
// + dz*dz, in that order) is strictly below r2, the float32 square of
// float32(radius). Per query: the nsample smallest original indices of the
// in-ball columns, ascending (the first nsample in dataset order), unused
// slots repeating the first (0 for an empty ball), and min(#in-ball, nsample).
// With kWithPos, each pick's window column too (0 for an empty ball). The
// windowed kernel also takes hi[b,t], the column after the tile's last
// candidate: a tile with hi - lo > w does not fit its window, and its queries
// take the whole sorted cloud [0, n) as their range instead. Any x-sorted
// range that holds every in-ball column gives the same answer (the nsample
// smallest original indices of the in-ball columns), so the output is the
// exact ball query whichever tiles fit. The JAX wrapper decides the same with
// a lax.cond over all tiles at once, and runs the exact kernel over the
// unsorted cloud; here each block decides for its own tile, and nothing goes
// back to the host.
//
// What bounds it on the H100: operations, about 9 a (query, column) pair
// scanned; the columns are read from device memory once a block. The TPU
// kernel extracts the picks with nsample full-width min passes over a
// (tm, w) key block; here each pair is looked at once, and only the pairs
// that can hit.
//
// Design of both kernels (rows 7, 8 and 11), for the card: each tile's
// queries are split over `split` blocks of `warps` warps (the plans in
// ops/cuda/ballquery.py fill the card: at SA1 8 blocks a tile at B=8 and 4
// at B=16, where one block a tile left 64 or 128 blocks on 132 SMs). The
// range is sorted by x, and a column whose rounded dx^2 alone reaches r2 is
// never in the ball (adding the rounded dy^2 and dz^2 cannot lower the sum):
// such columns form the two ends of the range. So each warp finds, by a
// search of 32 probes a round, the span of columns its block's queries can
// hit (the first query's left end to the last query's right end); the block
// stages only that span in shared memory as 16-byte (x, y, z, original
// index) quads, one 16-byte load a column, when it fits the block's buffer;
// and each query scans only its own span, found the same way (at SA1 about a
// third of a 3072-column window, about 990 of the 8192 sorted columns). The
// count, the picks and their columns are those of the whole range. A span
// wider than the buffer is read where it lies, with the same spans. The
// round-1 kernel's buffer holds min(n, w) columns, as the tiles kernel's (a
// fitting tile's span is at most w; a falling-back tile's block whose span
// is wider reads it where it lies), none where that passes kMaxSharedWindow.
//
// Design common to the scans: one warp per query: it walks its columns in
// 32-column strips, `__ballot_sync` gives the strip's in-ball lanes, `__popc`
// counts them, and each hit is inserted into a sorted list of the nsample
// smallest original indices. For nsample <= 32 the warp holds the list one
// slot a lane: the slots below the new key stay, the rest shift up one lane
// (`__shfl_up_sync`), and the key takes the free lane. For a larger nsample
// the list lives in the query's own output row (and the picks' columns in the
// position row) and the warp shifts it 32 slots at a time. Original indices
// are unique, so no removal is needed.

#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace pn2_window {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSlots = 32;    // one slot a lane
// Blocks of up to 32 warps. The round-1 kernel's slot variant is held to 32
// registers (two such blocks an SM): its plan counts 4 blocks of 16 warps an
// SM, which more registers would cut to 3. The tiles kernel (rows 7 and 8)
// keeps a body of its own with no bound: ptxas fits it in 29 registers, and
// held to 32 the body it shared with the round-1 kernel ran 2-3 % slower
// (PERF.md).
constexpr int kMaxBlockThreads = 1024;
// The widest window that fits a block's 227 KB of dynamic shared memory.
constexpr int kMaxSharedWindow = 232448 / 16;

__device__ __forceinline__ float dist2(float x, float y, float z,
                                       float x1, float y1, float z1) {
  const float dx = __fsub_rn(x, x1);
  const float dy = __fsub_rn(y, y1);
  const float dz = __fsub_rn(z, z1);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// A window read where it lies: sorted (x, y, z) rows and their original indices.
struct GlobalColumns {
  const float* xyz;
  const int* orig;
  __device__ __forceinline__ float xat(int j) const { return xyz[3 * j]; }
  __device__ __forceinline__ void get(int j, float& cx, float& cy, float& cz,
                                      int& o) const {
    cx = xyz[3 * j + 0];
    cy = xyz[3 * j + 1];
    cz = xyz[3 * j + 2];
    o = orig[j];
  }
  // Column j as an (x, y, z, original index) quad.
  __device__ __forceinline__ float4 quad(int j) const {
    return make_float4(xyz[3 * j], xyz[3 * j + 1], xyz[3 * j + 2], __int_as_float(orig[j]));
  }
};

// Window columns [first, first + len) staged in shared memory as 16-byte
// (x, y, z, original index) quads: one 16-byte load a column. Takes the
// window column j, as GlobalColumns does.
struct SharedQuads {
  const float4* quads;
  int first;
  __device__ __forceinline__ float xat(int j) const { return quads[j - first].x; }
  __device__ __forceinline__ float4 quad(int j) const { return quads[j - first]; }
  __device__ __forceinline__ void get(int j, float& cx, float& cy, float& cz,
                                      int& o) const {
    const float4 v = quads[j - first];
    cx = v.x;
    cy = v.y;
    cz = v.z;
    o = __float_as_int(v.w);
  }
};

// Stages columns [begin, end) of `cols` into `dst` as quads (dst[0] is column
// begin) and returns them as SharedQuads. Every thread of the block calls it.
__device__ __forceinline__ SharedQuads stage_quads(float4* dst, const GlobalColumns& cols,
                                                   int begin, int end) {
  for (int j = begin + threadIdx.x; j < end; j += blockDim.x) dst[j - begin] = cols.quad(j);
  __syncthreads();
  return SharedQuads{dst, begin};
}

// Along x-sorted columns the x difference dx = fl(qx - cx) falls as cx
// grows, and fl(dx * dx) grows with |dx|; the rounded dy^2 and dz^2 it is
// added to are not negative, so a column with fl(dx * dx) >= r2 is never in
// the ball. Such columns lie left of the query (dx > 0) on a prefix of the
// window and right of it (dx < 0) on a suffix.
__device__ __forceinline__ bool far_left(float qx, float cx, float r2) {
  const float dx = __fsub_rn(qx, cx);
  return dx > 0.f && __fmul_rn(dx, dx) >= r2;
}

__device__ __forceinline__ bool not_far_right(float qx, float cx, float r2) {
  const float dx = __fsub_rn(qx, cx);
  return !(dx < 0.f && __fmul_rn(dx, dx) >= r2);
}

// One round of a warp's search for the first column in [begin, end) at which
// the predicate (far_left if kLeft, else not_far_right: true on a prefix of
// the columns) is false: 32 probes narrow the range to one step between two
// probes; a range of 32 columns or fewer is probed whole. The search is over
// when begin == end, and the answer is begin.
template <bool kLeft, class Columns>
__device__ __forceinline__ void x_round(const Columns& cols, int& begin, int& end, float qx,
                                        float r2, int lane) {
  const int len = end - begin;
  const int step = len > 32 ? (len + 31) >> 5 : 1;
  const int j = begin + lane * step;
  bool p = false;
  if (j < end) {
    const float cx = cols.xat(j);
    p = kLeft ? far_left(qx, cx, r2) : not_far_right(qx, cx, r2);
  }
  const int k = __popc(__ballot_sync(kFull, p));
  if (step == 1) {
    begin += k;
    end = begin;
  } else if (k == 0) {
    end = begin;
  } else {
    end = min(end, begin + k * step);
    begin += (k - 1) * step + 1;
  }
}

// The columns of [begin, end) that queries with x in [qx_first, qx_last) can
// hit: from qx_first's first column not far left to qx_last's first column
// far right. One warp, the two searches in step (a window of 3072 columns
// takes three rounds), the same answer in every lane.
template <class Columns>
__device__ __forceinline__ int2 x_span(const Columns& cols, int begin, int end, float qx_first,
                                       float qx_last, float r2, int lane) {
  int lb = begin, le = end, rb = begin, re = end;
  while (le > lb || re > rb) {
    if (le > lb) x_round<true>(cols, lb, le, qx_first, r2, lane);
    if (re > rb) x_round<false>(cols, rb, re, qx_last, r2, lane);
  }
  return make_int2(lb, max(lb, rb));
}

// One warp, one query, columns [begin, end); nsample <= 32. On return lane
// s < nsample holds the s-th smallest in-ball original index in `key` (INT_MAX
// past the hits) and its column in `col`; `count` is the number of in-ball
// columns, the same in every lane.
template <class Columns>
__device__ __forceinline__ void scan_slots(const Columns& cols, int begin, int end, float qx,
                                           float qy, float qz, float r2, int nsample,
                                           int lane, int& key, int& col, int& count) {
  const bool holds_slot = lane < nsample;
  key = INT_MAX;
  col = 0;
  count = 0;
  for (int base = begin; base < end; base += 32) {
    const int j = base + lane;
    bool in = false;
    int orig = 0;
    if (j < end) {
      float cx, cy, cz;
      cols.get(j, cx, cy, cz, orig);
      in = dist2(qx, qy, qz, cx, cy, cz) < r2;
    }
    unsigned hits = __ballot_sync(kFull, in);
    count += __popc(hits);
    while (hits != 0u) {
      const int src_lane = __ffs(hits) - 1;
      hits &= hits - 1u;
      const int v = __shfl_sync(kFull, orig, src_lane);
      // Slots holding a smaller key are the lowest lanes; v goes after them.
      const int at = __popc(__ballot_sync(kFull, holds_slot && key < v));
      const int up_key = __shfl_up_sync(kFull, key, 1);
      const int up_col = __shfl_up_sync(kFull, col, 1);
      if (at < nsample) {
        if (lane > at) {
          key = up_key;
          col = up_col;
        } else if (lane == at) {
          key = v;
          col = base + src_lane;
        }
      }
    }
  }
}

// The same scan for any nsample: the sorted list is the query's output row
// `list` (device memory that only this warp touches), and with kWithPos each
// pick's column rides along in `pos`, shifted with it. Columns [begin, end).
// Returns the number of in-ball columns; list[0 .. min(count, nsample)) holds
// the picks.
template <class Columns, bool kWithPos = false>
__device__ int scan_list(const Columns& cols, int begin, int end, float qx, float qy, float qz,
                         float r2, int nsample, int lane, int* list, int* pos = nullptr) {
  int count = 0;
  for (int base = begin; base < end; base += 32) {
    const int j = base + lane;
    bool in = false;
    int orig = 0;
    if (j < end) {
      float cx, cy, cz;
      cols.get(j, cx, cy, cz, orig);
      in = dist2(qx, qy, qz, cx, cy, cz) < r2;
    }
    unsigned hits = __ballot_sync(kFull, in);
    while (hits != 0u) {
      const int src_lane = __ffs(hits) - 1;
      hits &= hits - 1u;
      const int v = __shfl_sync(kFull, orig, src_lane);
      const int held = count < nsample ? count : nsample;
      int below = 0;
      for (int s = lane; s < held; s += 32) below += list[s] < v;
      const int at = __reduce_add_sync(kFull, below);
      if (at < nsample) {
        // Slots at .. top-1 move up one, from the top down, 32 at a time.
        const int top = held < nsample - 1 ? held : nsample - 1;
        for (int hi_s = top; hi_s > at; hi_s -= 32) {
          const int s = hi_s - lane;
          const bool moves = s > at;
          int moved = 0, moved_col = 0;
          if (moves) {
            moved = list[s - 1];
            if (kWithPos) moved_col = pos[s - 1];
          }
          __syncwarp();
          if (moves) {
            list[s] = moved;
            if (kWithPos) pos[s] = moved_col;
          }
          __syncwarp();
        }
        if (lane == 0) {
          list[at] = v;
          if (kWithPos) pos[at] = base + src_lane;
        }
        __syncwarp();
      }
      ++count;
    }
  }
  return count;
}

// Grid (tiles * split, b), `warps` warps a block, 16 * w bytes of dynamic
// shared memory when `staged` (w <= kMaxSharedWindow), else none: the window
// is read where it lies. xs (b, n, 3), perm (b, n), qs (b, m, 3) sorted; lo
// (b, tiles) with lo + w <= n; idx/pos (b, m, nsample), cnt (b, m) in sorted
// query order. Block (tile, part) takes the tm / split sorted queries
// [part * tm / split, (part + 1) * tm / split) of the tile. kSlots: nsample
// <= 32, the list in registers; else in the output rows.
template <bool kWithPos, bool kSlots>
__global__ void ball_query_tiles_kernel(const float* __restrict__ xs,
                                        const int* __restrict__ perm,
                                        const float* __restrict__ qs,
                                        const int* __restrict__ lo, int n,
                                        int m, int tm, int w, int split, bool staged, float r2,
                                        int nsample, int* __restrict__ idx,
                                        int* __restrict__ pos,
                                        int* __restrict__ cnt) {
  extern __shared__ float4 quads[];
  const int tile = blockIdx.x / split;
  const int part = blockIdx.x - tile * split;
  const int b = blockIdx.y;
  const int start = lo[b * (gridDim.x / split) + tile];
  const GlobalColumns window{xs + ((size_t)b * n + start) * 3, perm + (size_t)b * n + start};
  const int per_block = tm / split;
  const size_t q0 = (size_t)b * m + (size_t)tile * tm + (size_t)part * per_block;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;

  // The columns the block's queries can hit: from the first query's left
  // boundary to the last query's right one (the queries are sorted by x, and
  // both boundaries move right with the query). Every warp finds them itself:
  // the block then needs no shared memory beside the window's w columns.
  const int2 span = x_span(window, 0, w, qs[q0 * 3], qs[(q0 + per_block - 1) * 3], r2, lane);
  const SharedQuads shared{quads, span.x};
  if (staged) {
    for (int j = span.x + threadIdx.x; j < span.y; j += blockDim.x) {
      quads[j - span.x] = make_float4(window.xyz[3 * j], window.xyz[3 * j + 1], window.xyz[3 * j + 2],
                                      __int_as_float(window.orig[j]));
    }
    __syncthreads();
  }

  for (int qi = warp; qi < per_block; qi += warps) {
    const size_t q = q0 + qi;
    const float qx = qs[q * 3 + 0];
    const float qy = qs[q * 3 + 1];
    const float qz = qs[q * 3 + 2];
    const int2 cols = staged ? x_span(shared, span.x, span.y, qx, qx, r2, lane)
                             : x_span(window, span.x, span.y, qx, qx, r2, lane);
    const int begin = cols.x, end = cols.y;
    int c;
    if constexpr (kSlots) {
      int key, col, count;
      if (staged) {
        scan_slots(shared, begin, end, qx, qy, qz, r2, nsample, lane, key, col, count);
      } else {
        scan_slots(window, begin, end, qx, qy, qz, r2, nsample, lane, key, col, count);
      }
      c = count < nsample ? count : nsample;
      const int first_key = __shfl_sync(kFull, key, 0);
      const int first_col = __shfl_sync(kFull, col, 0);
      if (lane < nsample) {
        const bool used = lane < c;
        idx[q * nsample + lane] = used ? key : (c > 0 ? first_key : 0);
        if (kWithPos) pos[q * nsample + lane] = used ? col : (c > 0 ? first_col : 0);
      }
    } else {
      int* out = idx + q * nsample;
      int* out_pos = kWithPos ? pos + q * nsample : nullptr;
      const int count =
          staged ? scan_list<SharedQuads, kWithPos>(shared, begin, end, qx, qy, qz, r2, nsample, lane, out, out_pos)
                 : scan_list<GlobalColumns, kWithPos>(window, begin, end, qx, qy, qz, r2, nsample, lane, out, out_pos);
      c = count < nsample ? count : nsample;
      const int first = c > 0 ? out[0] : 0;
      const int first_col = kWithPos && c > 0 ? out_pos[0] : 0;
      __syncwarp();
      for (int s = c + lane; s < nsample; s += 32) {
        out[s] = first;
        if (kWithPos) out_pos[s] = first_col;
      }
    }
    if (lane == 0) cnt[q] = c;
  }
}

// split: blocks a tile (tm % split == 0); warps: warps a block (1 to 32).
template <bool kWithPos>
cudaError_t launch_ball_query_tiles(const float* xs, const int* perm,
                                    const float* qs, const int* lo, int b,
                                    int n, int m, int tm, int w, int split, int warps, float r2,
                                    int nsample, int* idx, int* pos, int* cnt,
                                    cudaStream_t stream) {
  if (split < 1 || tm % split || warps < 1 || warps > 32 || (long long)(m / tm) * split > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  const bool staged = w <= kMaxSharedWindow;
  const size_t smem = staged ? (size_t)w * 16 : 0;
  auto* kernel = nsample <= kMaxSlots ? &ball_query_tiles_kernel<kWithPos, true>
                                      : &ball_query_tiles_kernel<kWithPos, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((m / tm) * split, b);
  kernel<<<grid, warps * 32, smem, stream>>>(xs, perm, qs, lo, n, m, tm, w, split, staged, r2,
                                             nsample, idx, pos, cnt);
  return cudaGetLastError();
}

// Grid b * tiles * split (cloud-major, one dimension: any number of clouds),
// `warps` warps a block, 16 * capacity bytes of dynamic shared memory. xs
// (b, n, 3), perm (b, n), qs (b, m, 3) sorted; lo, hi (b, tiles); idx (b, m,
// nsample), cnt (b, m) in sorted query order. A tile with hi - lo <= w takes
// its window [lo, min(lo + w, n)) as its range, any other the whole sorted
// cloud [0, n). Block (tile, part) takes the tm / split sorted queries
// [part * tm / split, (part + 1) * tm / split) of the tile. The block's
// x-span is staged as quads when it holds at most `capacity` columns, else
// read where it lies; each warp takes a query at a time over its own x-span.
// kSlots: nsample <= 32, the list in registers; else in the output rows.
template <bool kSlots>
__global__ void __launch_bounds__(kMaxBlockThreads, kSlots ? 2 : 1)
    ball_query_windowed_kernel(const float* __restrict__ xs, const int* __restrict__ perm,
                               const float* __restrict__ qs, const int* __restrict__ lo,
                               const int* __restrict__ hi, int n, int m, int tm, int w, int split,
                               int capacity, float r2, int nsample, int* __restrict__ idx,
                               int* __restrict__ cnt) {
  extern __shared__ float4 quads[];
  const int t = blockIdx.x / split;  // b * tiles + tile
  const int part = blockIdx.x - t * split;
  const int b = t / (m / tm);
  const int start = lo[t];
  const bool fits = hi[t] - start <= w;  // the same in the whole block
  const int first = fits ? start : 0;
  const int len = fits ? max(0, min(w, n - start)) : n;
  const GlobalColumns range{xs + ((size_t)b * n + first) * 3, perm + (size_t)b * n + first};
  const int per_block = tm / split;
  const size_t q0 = (size_t)t * tm + (size_t)part * per_block;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;

  // The block's span, as in the tiles kernel; every warp finds the same one,
  // so `staged` is the same in the whole block.
  const int2 span = x_span(range, 0, len, qs[q0 * 3], qs[(q0 + per_block - 1) * 3], r2, lane);
  const bool staged = span.y - span.x <= capacity;
  const SharedQuads shared = staged ? stage_quads(quads, range, span.x, span.y) : SharedQuads{quads, 0};

  for (int qi = warp; qi < per_block; qi += warps) {
    const size_t q = q0 + qi;
    const float qx = qs[q * 3 + 0];
    const float qy = qs[q * 3 + 1];
    const float qz = qs[q * 3 + 2];
    const int2 cols = staged ? x_span(shared, span.x, span.y, qx, qx, r2, lane)
                             : x_span(range, span.x, span.y, qx, qx, r2, lane);
    const int begin = cols.x, end = cols.y;
    int c;
    if constexpr (kSlots) {
      int key, col, count;
      if (staged) {
        scan_slots(shared, begin, end, qx, qy, qz, r2, nsample, lane, key, col, count);
      } else {
        scan_slots(range, begin, end, qx, qy, qz, r2, nsample, lane, key, col, count);
      }
      c = count < nsample ? count : nsample;
      const int first_key = __shfl_sync(kFull, key, 0);
      if (lane < nsample) idx[q * nsample + lane] = lane < c ? key : (c > 0 ? first_key : 0);
    } else {
      int* out = idx + q * nsample;
      const int count = staged ? scan_list(shared, begin, end, qx, qy, qz, r2, nsample, lane, out)
                               : scan_list(range, begin, end, qx, qy, qz, r2, nsample, lane, out);
      c = count < nsample ? count : nsample;
      const int first_key = c > 0 ? out[0] : 0;
      __syncwarp();
      for (int s = c + lane; s < nsample; s += 32) out[s] = first_key;
    }
    if (lane == 0) cnt[q] = c;
  }
}

// split: blocks a tile (tm % split == 0); warps: warps a block (1 to 32).
// A block stages up to min(n, w) columns, none where that passes
// kMaxSharedWindow.
inline cudaError_t launch_ball_query_windowed(const float* xs, const int* perm, const float* qs,
                                              const int* lo, const int* hi, int b, int n, int m,
                                              int tm, int w, int split, int warps, float r2,
                                              int nsample, int* idx, int* cnt, cudaStream_t stream) {
  if (split < 1 || tm < 1 || tm % split || warps < 1 || warps > 32 ||
      (long long)b * (m / tm) * split > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  const int capacity = min(n, w) <= kMaxSharedWindow ? min(n, w) : 0;
  const size_t smem = (size_t)capacity * 16;
  auto* kernel = nsample <= kMaxSlots ? &ball_query_windowed_kernel<true>
                                      : &ball_query_windowed_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<b * (m / tm) * split, warps * 32, smem, stream>>>(xs, perm, qs, lo, hi, n, m, tm, w,
                                                             split, capacity, r2, nsample, idx, cnt);
  return cudaGetLastError();
}

}  // namespace pn2_window
