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
// exact, so dense regions cost less than the full N.
//
// Design: one warp per query. The warp walks the dataset in index order in
// 32-point strips; `__ballot_sync` gives the strip's in-ball mask and
// `__popc` of the lanes below each hit gives its slot, so the hits append in
// order without shared memory or a sort. The ragged edge is masked by index
// (no padded coordinates), and the pad value is kept in a register.
//
// The per-query scan is `pn2_window::exact_scan` (window_bq.cuh), which the
// round-1 windowed kernel's fallback runs too. `pn2_ball_query_tiles` (the
// calibrated-window variant) and `pn2_ball_query_windowed` (the round-1
// windowed ball query) are the kernels of window_bq.cuh, which says what they
// replace and how they work.

#include <cuda_runtime.h>

#include "window_bq.cuh"

namespace {

__global__ void ball_query_kernel(const float* __restrict__ xyz1,
                                  const float* __restrict__ xyz2, int b, int n,
                                  int m, float r2, int nsample,
                                  int* __restrict__ idx, int* __restrict__ cnt) {
  const int warps_per_block = blockDim.x >> 5;
  const long long q = (long long)blockIdx.x * warps_per_block + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= (long long)b * m) return;  // the whole warp leaves together

  const int c = pn2_window::exact_scan(xyz1 + (size_t)(q / m) * n * 3, n, xyz2[q * 3 + 0],
                                       xyz2[q * 3 + 1], xyz2[q * 3 + 2], r2, nsample, lane,
                                       idx + q * nsample);
  if (lane == 0) cnt[q] = c;
}

}  // namespace

extern "C" {

// xyz1 (b, n, 3) dataset, xyz2 (b, m, 3) queries, f32 ->
// idx (b, m, nsample) i32, cnt (b, m) i32. Returns cudaGetLastError().
int pn2_ball_query(const float* xyz1, const float* xyz2, int b, int n, int m,
                   float r2, int nsample, int* idx, int* cnt, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;  // 8 queries a block
  const long long queries = (long long)b * m;
  const int blocks = (int)((queries + (threads / 32) - 1) / (threads / 32));
  ball_query_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(xyz1, xyz2, b, n, m, r2,
                                                                   nsample, idx, cnt);
  return (int)cudaGetLastError();
}

// The windowed ball query over x-sorted query tiles: xs (b, n, 3) f32 and
// perm (b, n) i32 the sorted cloud and its original indices, qs (b, m, 3) f32
// the sorted queries, lo (b, m / tm) i32 each tile's window start, w the
// window (lo + w <= n, w * 16 bytes of shared memory), nsample <= 32 ->
// idx (b, m, nsample) i32, cnt (b, m) i32, in sorted query order.
int pn2_ball_query_tiles(const float* xs, const int* perm, const float* qs,
                         const int* lo, int b, int n, int m, int tm, int w,
                         float r2, int nsample, int* idx, int* cnt, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)pn2_window::launch_ball_query_tiles<false>(
      xs, perm, qs, lo, b, n, m, tm, w, r2, nsample, idx, nullptr, cnt,
      (cudaStream_t)stream);
}

// The round-1 windowed ball query over x-sorted query tiles: xyz1 (b, n, 3)
// f32 the unsorted cloud, xs (b, n, 3) f32 and perm (b, n) i32 the sorted cloud
// and its original indices, qs (b, m, 3) f32 the sorted queries in tiles of
// tm, lo and hi (b, m / tm) i32 each tile's window start and the column after
// its last candidate, w the window (any width; more than kMaxSharedWindow
// columns are read from device memory), any nsample -> idx (b, m, nsample)
// i32, cnt (b, m) i32, in sorted query order. A tile with hi - lo > w scans
// the unsorted cloud exactly.
int pn2_ball_query_windowed(const float* xyz1, const float* xs, const int* perm,
                            const float* qs, const int* lo, const int* hi, int b, int n,
                            int m, int tm, int w, float r2, int nsample, int* idx,
                            int* cnt, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)pn2_window::launch_ball_query_windowed(xyz1, xs, perm, qs, lo, hi, b, n, m,
                                                     tm, w, r2, nsample, idx, cnt,
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
