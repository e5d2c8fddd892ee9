// Ball-query scans shared by ballquery.cu and wingather.cu: the exact scan of
// one query in dataset order, the windowed scan of one query over x-sorted
// columns, and the two kernels built from them over tiles of x-sorted queries.
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
// take the exact scan of the unsorted cloud instead, so the output is the
// exact ball query whichever tiles fit. The JAX wrapper decides the same with
// a lax.cond over all tiles at once; here each block decides for its own
// tile, and nothing goes back to the host.
//
// What bounds it on the H100: operations, about 9 a (query, column) pair of
// the m x w scan (of the pairs up to the nsample-th hit in a tile that falls
// back); the window is read from device memory once a tile. The TPU kernel
// extracts the picks with nsample full-width min passes over a (tm, w) key
// block; here each pair is looked at once.
//
// Design: one block per (cloud, tile). The window goes to dynamic shared
// memory as four arrays (x, y, z, original index; 16 bytes a column, 48 KB
// at w = 3072); a window wider than shared memory holds (kMaxSharedWindow
// columns) is read where it lies, through L1 and L2. One warp per query: it
// walks the window in 32-column strips, `__ballot_sync` gives the strip's
// in-ball lanes, `__popc` counts them, and each hit is inserted into a
// sorted list of the nsample smallest original indices. For nsample <= 32
// the warp holds the list one slot a lane: the slots below the new key stay,
// the rest shift up one lane (`__shfl_up_sync`), and the key takes the free
// lane. For a larger nsample the list lives in the query's own output row
// (and the picks' columns in the position row) and the warp shifts it 32
// slots at a time. Original indices are unique, so no
// removal is needed. The exact scan walks the cloud in dataset order and
// appends the hits (the slot of a hit is the count so far plus the `__popc`
// of the hits in lower lanes), stopping at nsample hits.

#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace pn2_window {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBqThreads = 512;  // 16 warps, 8 queries each in a tile of 128
constexpr int kMaxSlots = 32;    // one slot a lane
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

// A window staged in shared memory as four arrays.
struct SharedColumns {
  const float* x;
  const float* y;
  const float* z;
  const int* orig;
  __device__ __forceinline__ void get(int j, float& cx, float& cy, float& cz,
                                      int& o) const {
    cx = x[j];
    cy = y[j];
    cz = z[j];
    o = orig[j];
  }
};

// A window read where it lies: sorted (x, y, z) rows and their original indices.
struct GlobalColumns {
  const float* xyz;
  const int* orig;
  __device__ __forceinline__ void get(int j, float& cx, float& cy, float& cz,
                                      int& o) const {
    cx = xyz[3 * j + 0];
    cy = xyz[3 * j + 1];
    cz = xyz[3 * j + 2];
    o = orig[j];
  }
};

// One warp, one query, `len` columns; nsample <= 32. On return lane s < nsample
// holds the s-th smallest in-ball original index in `key` (INT_MAX past the
// hits) and its column in `col`; `count` is the number of in-ball columns, the
// same in every lane.
template <class Columns>
__device__ __forceinline__ void scan_slots(const Columns& cols, int len, float qx,
                                           float qy, float qz, float r2, int nsample,
                                           int lane, int& key, int& col, int& count) {
  const bool holds_slot = lane < nsample;
  key = INT_MAX;
  col = 0;
  count = 0;
  for (int base = 0; base < len; base += 32) {
    const int j = base + lane;
    bool in = false;
    int orig = 0;
    if (j < len) {
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
// pick's column rides along in `pos`, shifted with it. Returns the number of
// in-ball columns; list[0 .. min(count, nsample)) holds the picks.
template <class Columns, bool kWithPos = false>
__device__ int scan_list(const Columns& cols, int len, float qx, float qy, float qz,
                         float r2, int nsample, int lane, int* list, int* pos = nullptr) {
  int count = 0;
  for (int base = 0; base < len; base += 32) {
    const int j = base + lane;
    bool in = false;
    int orig = 0;
    if (j < len) {
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

// The exact ball query of one query, one warp: the first nsample in-ball
// points of data (n points, dataset order) appended to out, unused slots
// repeating the first hit (0 for none). Returns min(#in-ball, nsample).
__device__ __forceinline__ int exact_scan(const float* __restrict__ data, int n,
                                          float qx, float qy, float qz, float r2,
                                          int nsample, int lane, int* __restrict__ out) {
  int count = 0;  // hits so far, the same in every lane
  int first = 0;
  for (int base = 0; base < n && count < nsample; base += 32) {
    const int j = base + lane;
    bool in = false;
    if (j < n) {
      in = dist2(qx, qy, qz, data[j * 3 + 0], data[j * 3 + 1], data[j * 3 + 2]) < r2;
    }
    const unsigned mask = __ballot_sync(kFull, in);
    if (mask != 0u) {
      if (count == 0) first = base + __ffs(mask) - 1;
      if (in) {
        const int slot = count + __popc(mask & ((1u << lane) - 1u));
        if (slot < nsample) out[slot] = j;
      }
      count += __popc(mask);
    }
  }
  const int c = count < nsample ? count : nsample;
  for (int s = c + lane; s < nsample; s += 32) out[s] = first;
  return c;
}

// Stages columns [0, len) of a window into shared memory as four arrays of
// stride w (x, y, z split from the coalesced rows). Every thread of the block
// calls it.
__device__ __forceinline__ SharedColumns stage_window(float* smem, int w, int len,
                                                      const float* __restrict__ src,
                                                      const int* __restrict__ psrc) {
  float* sx = smem;
  float* sy = sx + w;
  float* sz = sy + w;
  int* so = reinterpret_cast<int*>(sz + w);
  for (int i = threadIdx.x; i < 3 * len; i += blockDim.x) {
    const int j = i / 3;
    smem[(i - 3 * j) * w + j] = src[i];
  }
  for (int j = threadIdx.x; j < len; j += blockDim.x) so[j] = psrc[j];
  __syncthreads();
  return SharedColumns{sx, sy, sz, so};
}

// Grid (tiles, b), kBqThreads threads, 16 * w bytes of dynamic shared memory
// when `staged` (w <= kMaxSharedWindow), else none: the window is read where
// it lies. xs (b, n, 3), perm (b, n), qs (b, m, 3) sorted; lo (b, tiles) with
// lo + w <= n; idx/pos (b, m, nsample), cnt (b, m) in sorted query order.
// kSlots: nsample <= 32, the list in registers; else in the output rows.
template <bool kWithPos, bool kSlots>
__global__ void ball_query_tiles_kernel(const float* __restrict__ xs,
                                        const int* __restrict__ perm,
                                        const float* __restrict__ qs,
                                        const int* __restrict__ lo, int n,
                                        int m, int tm, int w, bool staged, float r2,
                                        int nsample, int* __restrict__ idx,
                                        int* __restrict__ pos,
                                        int* __restrict__ cnt) {
  extern __shared__ float smem[];
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int start = lo[b * gridDim.x + tile];
  const GlobalColumns window{xs + ((size_t)b * n + start) * 3, perm + (size_t)b * n + start};
  SharedColumns shared{};
  if (staged) shared = stage_window(smem, w, w, window.xyz, window.orig);

  const int lane = threadIdx.x & 31;
  for (int qi = threadIdx.x >> 5; qi < tm; qi += blockDim.x >> 5) {
    const size_t q = (size_t)b * m + (size_t)tile * tm + qi;
    const float qx = qs[q * 3 + 0];
    const float qy = qs[q * 3 + 1];
    const float qz = qs[q * 3 + 2];
    int c;
    if constexpr (kSlots) {
      int key, col, count;
      if (staged) {
        scan_slots(shared, w, qx, qy, qz, r2, nsample, lane, key, col, count);
      } else {
        scan_slots(window, w, qx, qy, qz, r2, nsample, lane, key, col, count);
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
          staged ? scan_list<SharedColumns, kWithPos>(shared, w, qx, qy, qz, r2, nsample, lane, out, out_pos)
                 : scan_list<GlobalColumns, kWithPos>(window, w, qx, qy, qz, r2, nsample, lane, out, out_pos);
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

template <bool kWithPos>
cudaError_t launch_ball_query_tiles(const float* xs, const int* perm,
                                    const float* qs, const int* lo, int b,
                                    int n, int m, int tm, int w, float r2,
                                    int nsample, int* idx, int* pos, int* cnt,
                                    cudaStream_t stream) {
  const bool staged = w <= kMaxSharedWindow;
  const size_t smem = staged ? (size_t)w * 16 : 0;
  auto* kernel = nsample <= kMaxSlots ? &ball_query_tiles_kernel<kWithPos, true>
                                      : &ball_query_tiles_kernel<kWithPos, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(m / tm, b);
  kernel<<<grid, kBqThreads, smem, stream>>>(xs, perm, qs, lo, n, m, tm, w, staged, r2,
                                            nsample, idx, pos, cnt);
  return cudaGetLastError();
}

// Grid b * tiles (cloud-major), kBqThreads threads, 16 * w bytes of dynamic
// shared memory when `staged` (w <= kMaxSharedWindow), else none.
// xyz1 (b, n, 3) the unsorted cloud; xs (b, n, 3), perm (b, n), qs (b, m, 3)
// sorted; lo, hi (b, tiles); idx (b, m, nsample), cnt (b, m) in sorted query
// order. kSlots: nsample <= 32, the list in registers.
template <bool kSlots>
__global__ void ball_query_windowed_kernel(const float* __restrict__ xyz1,
                                           const float* __restrict__ xs,
                                           const int* __restrict__ perm,
                                           const float* __restrict__ qs,
                                           const int* __restrict__ lo,
                                           const int* __restrict__ hi, int n, int m,
                                           int tm, int tiles, int w, bool staged,
                                           float r2, int nsample,
                                           int* __restrict__ idx, int* __restrict__ cnt) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x - b * tiles;
  const int start = lo[blockIdx.x];
  const bool fits = hi[blockIdx.x] - start <= w;  // the same in the whole block
  const int len = w < n - start ? w : n - start;  // columns of the window inside the cloud
  const GlobalColumns window{xs + ((size_t)b * n + start) * 3, perm + (size_t)b * n + start};
  const bool in_smem = fits && staged;
  SharedColumns shared{};
  if (in_smem) shared = stage_window(smem, w, len, window.xyz, window.orig);

  const float* cloud = xyz1 + (size_t)b * n * 3;
  const int lane = threadIdx.x & 31;
  for (int qi = threadIdx.x >> 5; qi < tm; qi += blockDim.x >> 5) {
    const size_t q = (size_t)b * m + (size_t)tile * tm + qi;
    const float qx = qs[q * 3 + 0];
    const float qy = qs[q * 3 + 1];
    const float qz = qs[q * 3 + 2];
    int* out = idx + q * nsample;
    int c;
    if (!fits) {
      c = exact_scan(cloud, n, qx, qy, qz, r2, nsample, lane, out);
    } else if constexpr (kSlots) {
      int key, col, count;
      if (in_smem) {
        scan_slots(shared, len, qx, qy, qz, r2, nsample, lane, key, col, count);
      } else {
        scan_slots(window, len, qx, qy, qz, r2, nsample, lane, key, col, count);
      }
      c = count < nsample ? count : nsample;
      const int first = __shfl_sync(kFull, key, 0);
      if (lane < nsample) out[lane] = lane < c ? key : (c > 0 ? first : 0);
    } else {
      const int count = in_smem ? scan_list(shared, len, qx, qy, qz, r2, nsample, lane, out)
                                : scan_list(window, len, qx, qy, qz, r2, nsample, lane, out);
      c = count < nsample ? count : nsample;
      const int first = c > 0 ? out[0] : 0;
      __syncwarp();
      for (int s = c + lane; s < nsample; s += 32) out[s] = first;
    }
    if (lane == 0) cnt[q] = c;
  }
}

inline cudaError_t launch_ball_query_windowed(const float* xyz1, const float* xs,
                                              const int* perm, const float* qs,
                                              const int* lo, const int* hi, int b, int n,
                                              int m, int tm, int w, float r2, int nsample,
                                              int* idx, int* cnt, cudaStream_t stream) {
  const int tiles = m / tm;
  const bool staged = w <= kMaxSharedWindow;
  const size_t smem = staged ? (size_t)w * 16 : 0;
  auto* kernel = nsample <= kMaxSlots ? &ball_query_windowed_kernel<true>
                                      : &ball_query_windowed_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<b * tiles, kBqThreads, smem, stream>>>(xyz1, xs, perm, qs, lo, hi, n, m, tm,
                                                  tiles, w, staged, r2, nsample, idx, cnt);
  return cudaGetLastError();
}

}  // namespace pn2_window
