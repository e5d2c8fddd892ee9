// The fused calibrated grouping of the SA1 eval path: a windowed ball query
// that also returns each pick's window column, and the gather of the
// projected rows at those columns.
//
// ---------------------------------------------------------------------------
// pn2_ball_query_tiles_pos: the kernel of window_bq.cuh with positions.
//
// Replaces: pointnet2_tpu/ops/pallas/wingather.py:54 `_bq_sliced_pos_kernel`
//           (launched by `project_group_sliced`, wingather.py:133-298).
//
// The TPU kernel encodes orig * w + column in one key so that its min passes
// carry the column along; here the warp's sorted slots carry the pair
// (original index, column) and shift both. What bounds it and how it works:
// window_bq.cuh.
//
// ---------------------------------------------------------------------------
// pn2_window_gather: out[b, q, s, :] = zp_s[b, lo[b, q / tm] + pos[b, q, s], :].
//
// Replaces: pointnet2_tpu/ops/pallas/wingather.py:98 `_window_gather_kernel`
//           (launched by `project_group_sliced`, wingather.py:285).
//
// Semantics: a row copy. zp_s (b, n, c) holds the projected features of the
// x-sorted cloud; each output row is the row at its tile's window start plus
// its pick's column. The result equals its plain version bit for bit.
//
// What bounds it on the H100: bytes, each output element written once (67 MB
// at SA1, batch 16, c = 32) and the source rows read once (16.8 MB; a tile's
// window rows are read again by the tile's other picks, from L2).
//
// Design: one thread per 16-byte vector of the output (float4 where c is a
// multiple of 4 and the rows are 16-byte aligned, else one float),
// consecutive threads on consecutive channels of one row, then the next
// row: the writes are coalesced, and the
// threads of a row read one contiguous source row. The TPU kernel copied two
// window blocks into VMEM and then rows out of them, because it had no vector
// gather; the blocks are not needed here (the block width is kept only in the
// wrapper's fallback condition, for parity of the paths with the JAX package).

#include <cstdint>
#include <cuda_runtime.h>

#include "window_bq.cuh"

namespace {

constexpr int kGatherThreads = 256;

template <typename V>
__global__ void window_gather_kernel(const V* __restrict__ zp,
                                     const int* __restrict__ lo,
                                     const int* __restrict__ pos, int n, int m,
                                     int tm, int k, int cv, long long total,
                                     V* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int tiles = m / tm;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const long long row = t / cv;  // (b * m + q) * k + s
    const int c = (int)(t - row * cv);
    const long long bq = row / k;
    const int b = (int)(bq / m);
    const int q = (int)(bq - (long long)b * m);
    const int src = lo[b * tiles + q / tm] + pos[row];
    out[t] = zp[((long long)b * n + src) * cv + c];
  }
}

template <typename V>
cudaError_t launch_gather(const float* zp, const int* lo, const int* pos, int b,
                          int n, int m, int tm, int k, int c, float* out,
                          cudaStream_t stream) {
  const int cv = c / (int)(sizeof(V) / sizeof(float));
  const long long total = (long long)b * m * k * cv;
  long long blocks = (total + kGatherThreads - 1) / kGatherThreads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;  // the loop strides over the rest
  window_gather_kernel<V><<<(unsigned)blocks, kGatherThreads, 0, stream>>>(
      reinterpret_cast<const V*>(zp), lo, pos, n, m, tm, k, cv, total,
      reinterpret_cast<V*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The windowed ball query with positions: as pn2_ball_query_tiles
// (ballquery.cu), plus pos (b, m, nsample) i32, each pick's window column.
int pn2_ball_query_tiles_pos(const float* xs, const int* perm, const float* qs,
                             const int* lo, int b, int n, int m, int tm, int w,
                             int split, int warps, float r2, int nsample, int* idx, int* pos,
                             int* cnt, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)pn2_window::launch_ball_query_tiles<true>(
      xs, perm, qs, lo, b, n, m, tm, w, split, warps, r2, nsample, idx, pos, cnt,
      (cudaStream_t)stream);
}

// zp (b, n, c) f32, lo (b, m / tm) i32, pos (b, m, k) i32 ->
// out (b, m, k, c) f32. Returns cudaGetLastError() after the launch.
int pn2_window_gather(const float* zp, const int* lo, const int* pos, int b,
                      int n, int m, int tm, int k, int c, float* out,
                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const bool aligned = c % 4 == 0 && reinterpret_cast<uintptr_t>(zp) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (aligned) return (int)launch_gather<float4>(zp, lo, pos, b, n, m, tm, k, c, out, s);
  return (int)launch_gather<float>(zp, lo, pos, b, n, m, tm, k, c, out, s);
}

const char* pn2_ball_query_tiles_pos_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

const char* pn2_window_gather_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
