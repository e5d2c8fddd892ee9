// Exact radius ball query: the first nsample in-ball points in dataset order.
//
// Replaces: pointnet2_tpu/ops/pallas/ballquery.py:42 `_ball_query_kernel`
//           (reached through `ball_query_pallas`, ballquery.py:413-473).
//
// Semantics: a dataset point is in the ball when its float32 difference-form
// squared distance (dx*dx + dy*dy + dz*dz, in that order) is strictly below
// r2, the float32 square of float32(radius). The first nsample such indices
// are returned in dataset order; unused slots repeat the first hit, or 0 for
// an empty ball; the count is capped at nsample.
//
// What bounds it on the H100: operations, about 9 a (query, point) pair, on
// the pairs that are scanned. The TPU kernel scans every pair and extracts
// the nsample smallest keys with nsample full-width min passes; here a query
// stops as soon as it has nsample hits, which the cap on the count makes
// exact, so dense regions cost less than the full N. At SA1 the balls (r =
// 0.5 in 8 x 8 x 4.9 m) hold about 14 points, fewer than nsample = 32, so
// nearly every query scans all N: 67 M pairs at B=8 and 134 M at B=16,
// which this kernel scans in about 52 and 88-100 us on an H100 (700 W),
// against 141 and 224-234 us for the design before (PERF.md).
//
// The design before this one (one warp a query, three scalar loads a lane of
// the (N, 3) rows through L1) was bound by L1 sectors, not by operations: a
// warp-wide load at a 12-byte stride spans 12 sectors for 4 useful bytes a
// lane, 36 sectors a 32-point strip, and no block shared the cloud that all
// of its queries read.
//
// Design: a block of W warps takes W x kQ queries of one cloud (W from the
// plan in ops/cuda/ballquery.py, kQ = 4). The block stages the cloud into
// shared memory, as it lies (x, y, z interleaved: a lane's float at word
// 3 * lane + c lands in a bank of its own, 3 being odd), in tiles of up to
// 4096 points with 4-byte `cp.async` into two buffers, so the next tile
// loads while the warps scan this one; it stops staging once every query of
// the block has nsample hits (`__syncthreads_and`). Each warp walks a tile in
// index order, two 32-point strips an iteration (twice the independent work
// between the loads and the ballots): every lane reads its points from
// shared memory once and tests each against the warp's kQ queries, held in
// registers; `__ballot_sync` gives each query's in-ball lanes and a hit's
// slot is the query's count so far plus the `__popc` of the hits in lower
// lanes, so the hits append in dataset order. A warp leaves the tile once its
// kQ queries are all done. Lanes past the tile's end read +inf, which no ball
// holds.
//
// `pn2_ball_query_tiles` (the calibrated-window variant) and
// `pn2_ball_query_windowed` (the round-1 windowed ball query) are the
// kernels of window_bq.cuh, which says what they replace and how they work;
// the windowed one's in-kernel fallback scans the whole sorted cloud over the
// same x-spans, and reads no unsorted cloud.

#include <cuda_runtime.h>

#include "window_bq.cuh"

namespace {

using pn2_window::dist2;
using pn2_window::kFull;

constexpr int kQ = 4;  // queries a warp: on the H100 8 were no faster at SA1 (PERF.md)
constexpr int kStrips = 2;  // 32-point strips an iteration: 15 % faster at SA1 than 1
constexpr int kMaxWarps = 16;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Points [t * tile, t * tile + len) of the cloud into buf, every thread a share.
__device__ __forceinline__ void stage(float* buf, const float* __restrict__ pts, int t, int tile,
                                      int len) {
  const float* src = pts + (size_t)t * tile * 3;
  for (int i = threadIdx.x; i < len * 3; i += blockDim.x) cp_async4(buf + i, src + i);
  cp_async_commit();
}

// Grid: b x ceil(m / (W * kQ)) blocks of W warps; dynamic shared memory
// min(2, tiles) x tile x 12 bytes.
__global__ void __launch_bounds__(kMaxWarps * 32)
    ball_query_kernel(const float* __restrict__ xyz1, const float* __restrict__ xyz2, int n,
                      int m, float r2, int nsample, int tile, int blocks_per_cloud,
                      int* __restrict__ idx, int* __restrict__ cnt) {
  extern __shared__ __align__(16) float tiles[];
  const int cloud = blockIdx.x / blocks_per_cloud;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int q0 = ((blockIdx.x - cloud * blocks_per_cloud) * warps + (threadIdx.x >> 5)) * kQ;
  const float* pts = xyz1 + (size_t)cloud * n * 3;

  float qx[kQ], qy[kQ], qz[kQ];
  int count[kQ], first[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int qi = q0 + q;
    const float* p = xyz2 + ((size_t)cloud * m + (qi < m ? qi : 0)) * 3;
    qx[q] = p[0];
    qy[q] = p[1];
    qz[q] = p[2];
    count[q] = qi < m ? 0 : nsample;  // a query past m is done from the start
    first[q] = 0;
  }
  int* out = idx + ((size_t)cloud * m + q0) * nsample;

  const int ntiles = (n + tile - 1) / tile;
  stage(tiles, pts, 0, tile, min(tile, n));
  if (ntiles > 1) stage(tiles + tile * 3, pts, 1, tile, min(tile, n - tile));
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* buf = tiles + (t & 1) * tile * 3;
    const int len = min(tile, n - t * tile);
    const int offset = t * tile;
    bool done = true;
#pragma unroll
    for (int q = 0; q < kQ; ++q) done = done && count[q] >= nsample;
    for (int s = 0; s < len && !done; s += 32 * kStrips) {
      float x[kStrips], y[kStrips], z[kStrips];
#pragma unroll
      for (int h = 0; h < kStrips; ++h) {
        const int j = s + 32 * h + lane;
        x[h] = y[h] = z[h] = __int_as_float(0x7f800000);  // +inf: in no ball
        if (j < len) {
          x[h] = buf[j * 3 + 0];
          y[h] = buf[j * 3 + 1];
          z[h] = buf[j * 3 + 2];
        }
      }
      unsigned mask[kStrips][kQ];
      unsigned any = 0u;
#pragma unroll
      for (int h = 0; h < kStrips; ++h) {
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          mask[h][q] = __ballot_sync(kFull, dist2(qx[q], qy[q], qz[q], x[h], y[h], z[h]) < r2);
          any |= mask[h][q];
        }
      }
      if (any == 0u) continue;  // the common case where balls are sparse
      done = true;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
#pragma unroll
        for (int h = 0; h < kStrips; ++h) {
          const unsigned mk = mask[h][q];
          if (mk != 0u) {
            const int at = offset + s + 32 * h;
            if (count[q] == 0) first[q] = at + __ffs(mk) - 1;
            if ((mk >> lane) & 1u) {
              const int slot = count[q] + __popc(mk & ((1u << lane) - 1u));
              if (slot < nsample) out[q * nsample + slot] = at + lane;
            }
            count[q] += __popc(mk);
          }
        }
        done = done && count[q] >= nsample;
      }
    }
    // Every warp is past this buffer: refill it, or stop if all are done.
    if (__syncthreads_and(done)) break;
    if (t + 2 < ntiles) {
      stage(tiles + (t & 1) * tile * 3, pts, t + 2, tile, min(tile, n - (t + 2) * tile));
    }
  }
  cp_async_wait<0>();  // nothing in flight into shared memory at exit

#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    if (q0 + q >= m) break;
    const int c = count[q] < nsample ? count[q] : nsample;
    for (int s = c + lane; s < nsample; s += 32) out[q * nsample + s] = first[q];
    if (lane == 0) cnt[(size_t)cloud * m + q0 + q] = c;
  }
}

}  // namespace

extern "C" {

// xyz1 (b, n, 3) dataset, xyz2 (b, m, 3) queries, f32 ->
// idx (b, m, nsample) i32, cnt (b, m) i32, in blocks of `warps` warps
// staging tiles of `tile` points (ops/cuda/ballquery.py `plan`).
// Returns cudaGetLastError().
int pn2_ball_query(const float* xyz1, const float* xyz2, int b, int n, int m,
                   float r2, int nsample, int warps, int tile, int* idx, int* cnt,
                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (warps < 1 || warps > kMaxWarps || tile < 32 || tile % 32) return (int)cudaErrorInvalidValue;
  const int per_block = warps * kQ;
  const int blocks_per_cloud = (m + per_block - 1) / per_block;
  const size_t smem = (size_t)(n > tile ? 2 : 1) * tile * 3 * sizeof(float);
  if ((long long)b * blocks_per_cloud > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(ball_query_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ball_query_kernel<<<b * blocks_per_cloud, warps * 32, smem, (cudaStream_t)stream>>>(
      xyz1, xyz2, n, m, r2, nsample, tile, blocks_per_cloud, idx, cnt);
  return (int)cudaGetLastError();
}

// The windowed ball query over x-sorted query tiles: xs (b, n, 3) f32 and
// perm (b, n) i32 the sorted cloud and its original indices, qs (b, m, 3) f32
// the sorted queries, lo (b, m / tm) i32 each tile's window start, w the
// window (lo + w <= n; up to kMaxSharedWindow columns staged in shared
// memory, a wider one read where it lies), any nsample, split blocks of
// `warps` warps a tile -> idx (b, m, nsample) i32, cnt (b, m) i32, in sorted
// query order.
int pn2_ball_query_tiles(const float* xs, const int* perm, const float* qs,
                         const int* lo, int b, int n, int m, int tm, int w,
                         int split, int warps, float r2, int nsample, int* idx, int* cnt,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)pn2_window::launch_ball_query_tiles<false>(
      xs, perm, qs, lo, b, n, m, tm, w, split, warps, r2, nsample, idx, nullptr, cnt,
      (cudaStream_t)stream);
}

// The round-1 windowed ball query over x-sorted query tiles: xs (b, n, 3)
// f32 and perm (b, n) i32 the sorted cloud and its original indices, qs
// (b, m, 3) f32 the sorted queries in tiles of tm, lo and hi (b, m / tm) i32
// each tile's window start and the column after its last candidate, w the
// window (any width), any nsample, split blocks of `warps` warps a tile ->
// idx (b, m, nsample) i32, cnt (b, m) i32, in sorted query order. A tile with
// hi - lo > w scans the whole sorted cloud over its queries' x-spans.
int pn2_ball_query_windowed(const float* xs, const int* perm, const float* qs, const int* lo,
                            const int* hi, int b, int n, int m, int tm, int w, int split,
                            int warps, float r2, int nsample, int* idx, int* cnt, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)pn2_window::launch_ball_query_windowed(xs, perm, qs, lo, hi, b, n, m, tm, w, split,
                                                     warps, r2, nsample, idx, cnt,
                                                     (cudaStream_t)stream);
}

const char* pn2_ball_query_windowed_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

const char* pn2_ball_query_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

const char* pn2_ball_query_tiles_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
