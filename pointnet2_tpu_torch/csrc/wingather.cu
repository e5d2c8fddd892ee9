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
// What bounds it on the H100: bytes. Each output element is written once
// (33.5 MB at SA1, batch 8, c = 32; 67.1 MB at batch 16); each distinct
// source row the picks name, the window starts and the picks are read once
// (8.1 + 1.0 MB at batch 8, where the picks name 96.5 % of the cloud's
// rows): 12.75 / 25.49 us at 3.35 TB/s, of which the output alone is 10.0 /
// 20.0 us. A tile's picks lie inside its w-row window, so a row picked again
// by the tile's other picks comes from L1 or L2.
//
// Design: no division on the hot path. The grid's z picks the cloud and y
// the tile (each looping past 65535), so the window start is read once a
// block into a uniform register and every offset inside the tile is 32-bit
// beside one 64-bit base a block; x picks a run of the tile's tm * k output
// rows. A row's 16-byte vectors (float4 where c is a multiple of 4 and both
// arrays are 16-byte aligned, else single floats: the same grid) go to
// kLanes consecutive lanes, a power of two up to 16 (a template parameter,
// so row and lane are a shift and a mask of threadIdx.x); rows wider than
// kLanes vectors loop over their channels. The row's lanes read its pick at
// one address, which the warp serves in one transaction. Each thread holds
// kUnroll rows: it issues the loads of all of them before any store, which
// keeps 4 L2 round trips in flight a thread (the TPU kernel's unroll=4).
// Loads take the read-only path; stores are coalesced, each pass of the
// block writing 256 consecutive vectors, and evict-first (__stcs): they beat
// default stores at both batches (PERF.md section 6 has both). At SA1 the
// planned route (16-byte vectors, 8 lanes) takes 12.6-12.8 / 30.1-30.2 us at
// batch 8 / 16, against 27.7-27.8 / 53.4 for the kernel before this design
// (one H100 at 700 W, tools/kernel_probe.py). At batch 8 that is the bound:
// in back-to-back calls the source and picks are still in L2, so the time is
// the output's, at 79 % of its own 10.0 us; PERF.md has the reads with the
// L2 cleared first.
// The TPU kernel copied two window blocks into VMEM and then rows out of
// them, because it had no vector gather; the blocks are not needed here (the
// block width is kept only in the wrapper's fallback condition, for parity of
// the paths with the JAX package).

#include <cstdint>
#include <cuda_runtime.h>

#include "window_bq.cuh"

namespace {

constexpr int kGatherThreads = 256;
constexpr int kUnroll = 4;  // rows in flight a thread
constexpr int kMaxGrid = 65535;

// rows = tm * k output rows a tile; cv = vectors a row.
template <typename V, int kLanes>
__global__ void __launch_bounds__(kGatherThreads)
    window_gather_kernel(const V* __restrict__ zp, const int* __restrict__ lo,
                         const int* __restrict__ pos, int b_count, int n, int tiles,
                         int rows, int cv, V* __restrict__ out) {
  constexpr int kRowsPass = kGatherThreads / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int first = blockIdx.x * (kRowsPass * kUnroll) + threadIdx.x / kLanes;
  for (int b = blockIdx.z; b < b_count; b += gridDim.z) {
    for (int t = blockIdx.y; t < tiles; t += gridDim.y) {
      const int tile = b * tiles + t;
      const V* src = zp + ((long long)b * n + __ldg(lo + tile)) * cv;
      const long long base = (long long)tile * rows;  // the tile's first output row
      const int* picks = pos + base;
      V* dst = out + base * cv;
      int at[kUnroll];  // each row's source offset in the window
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = first + u * kRowsPass;
        at[u] = r < rows ? __ldg(picks + r) * cv : 0;
      }
#pragma unroll 1
      for (int c = lane; c < cv; c += kLanes) {  // once where the row fits its lanes
        V v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (first + u * kRowsPass < rows) v[u] = __ldg(src + at[u] + c);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int r = first + u * kRowsPass;
          if (r < rows) __stcs(dst + r * cv + c, v[u]);
        }
      }
    }
  }
}

template <typename V, int kLanes>
cudaError_t launch_gather(const float* zp, const int* lo, const int* pos, int b, int n,
                          int tiles, int rows, int cv, float* out, cudaStream_t stream) {
  constexpr int kRowsBlock = kGatherThreads / kLanes * kUnroll;
  const dim3 grid((rows + kRowsBlock - 1) / kRowsBlock, tiles < kMaxGrid ? tiles : kMaxGrid,
                  b < kMaxGrid ? b : kMaxGrid);
  window_gather_kernel<V, kLanes><<<grid, kGatherThreads, 0, stream>>>(
      reinterpret_cast<const V*>(zp), lo, pos, b, n, tiles, rows, cv, reinterpret_cast<V*>(out));
  return cudaGetLastError();
}

template <typename V>
cudaError_t launch_lanes(int lanes, const float* zp, const int* lo, const int* pos, int b,
                         int n, int tiles, int rows, int cv, float* out, cudaStream_t s) {
  switch (lanes) {
    case 1: return launch_gather<V, 1>(zp, lo, pos, b, n, tiles, rows, cv, out, s);
    case 2: return launch_gather<V, 2>(zp, lo, pos, b, n, tiles, rows, cv, out, s);
    case 4: return launch_gather<V, 4>(zp, lo, pos, b, n, tiles, rows, cv, out, s);
    case 8: return launch_gather<V, 8>(zp, lo, pos, b, n, tiles, rows, cv, out, s);
    case 16: return launch_gather<V, 16>(zp, lo, pos, b, n, tiles, rows, cv, out, s);
    default: return cudaErrorInvalidValue;
  }
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
// out (b, m, k, c) f32 on the route (vec, lanes) that ops/cuda/wingather.py
// plans: 16-byte vectors or floats, lanes a row (1, 2, 4, 8 or 16). Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a route
// the arrays do not take.
int pn2_window_gather(const float* zp, const int* lo, const int* pos, int b, int n, int m,
                      int tm, int k, int c, int vec, int lanes, float* out, int device,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles = m / tm, rows = tm * k;
  if (vec) {
    const bool aligned = c % 4 == 0 && reinterpret_cast<uintptr_t>(zp) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(out) % 16 == 0;
    if (!aligned) return (int)cudaErrorInvalidValue;
    return (int)launch_lanes<float4>(lanes, zp, lo, pos, b, n, tiles, rows, c / 4, out, s);
  }
  return (int)launch_lanes<float>(lanes, zp, lo, pos, b, n, tiles, rows, c, out, s);
}

const char* pn2_ball_query_tiles_pos_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

const char* pn2_window_gather_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
