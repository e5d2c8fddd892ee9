// Windowed ball query over tiles of x-sorted queries: the kernel shared by
// `pn2_ball_query_tiles` (ballquery.cu) and `pn2_ball_query_tiles_pos`
// (wingather.cu).
//
// Replaces: pointnet2_tpu/ops/pallas/ballquery.py:247 `_ball_query_sliced_kernel`
//           and pointnet2_tpu/ops/pallas/wingather.py:54 `_bq_sliced_pos_kernel`.
//
// Semantics: the cloud (xs, with each column's original index in perm) and
// the queries (qs) are sorted by x. Query tile t of cloud b (tm queries) sees
// the w columns [lo[b,t], lo[b,t] + w) of the sorted cloud. A column is in
// the ball when its float32 difference-form squared distance (dx*dx + dy*dy
// + dz*dz, in that order) is strictly below r2, the float32 square of
// float32(radius). Per query: the nsample smallest original indices of the
// in-ball columns, ascending (the first nsample in dataset order), unused
// slots repeating the first (0 for an empty ball), and min(#in-ball, nsample).
// With kWithPos, each pick's window column too (0 for an empty ball).
//
// What bounds it on the H100: operations, about 9 a (query, column) pair of
// the m x w scan; the window is read from device memory once a tile. The TPU
// kernel extracts the picks with nsample full-width min passes over a
// (tm, w) key block; here each pair is looked at once.
//
// Design: one block per (cloud, tile). The window goes to dynamic shared
// memory as four arrays (x, y, z, original index; 16 bytes a column, 48 KB
// at w = 3072). One warp per query: it walks the window in 32-column strips,
// `__ballot_sync` gives the strip's in-ball lanes, `__popc` counts them, and
// each hit is inserted into a sorted list of the nsample smallest original
// indices that the warp holds one slot a lane: the slots below the new key
// stay, the rest shift up one lane (`__shfl_up_sync`), and the key takes the
// free lane. Original indices are unique, so no removal is needed, and
// nsample <= 32.

#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace pn2_window {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBqThreads = 512;  // 16 warps, 8 queries each in a tile of 128

__device__ __forceinline__ float dist2(float x, float y, float z,
                                       float x1, float y1, float z1) {
  const float dx = __fsub_rn(x, x1);
  const float dy = __fsub_rn(y, y1);
  const float dz = __fsub_rn(z, z1);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Grid (tiles, b), kBqThreads threads, 16 * w bytes of dynamic shared memory.
// xs (b, n, 3), perm (b, n), qs (b, m, 3) sorted; lo (b, tiles);
// idx/pos (b, m, nsample), cnt (b, m) in sorted query order.
template <bool kWithPos>
__global__ void ball_query_tiles_kernel(const float* __restrict__ xs,
                                        const int* __restrict__ perm,
                                        const float* __restrict__ qs,
                                        const int* __restrict__ lo, int n,
                                        int m, int tm, int w, float r2,
                                        int nsample, int* __restrict__ idx,
                                        int* __restrict__ pos,
                                        int* __restrict__ cnt) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + w;
  float* sz = sy + w;
  int* so = reinterpret_cast<int*>(sz + w);

  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int start = lo[b * gridDim.x + tile];
  const float* src = xs + ((size_t)b * n + start) * 3;
  for (int i = threadIdx.x; i < 3 * w; i += blockDim.x) {
    const int j = i / 3;
    smem[(i - 3 * j) * w + j] = src[i];  // coalesced read, x/y/z split
  }
  const int* psrc = perm + (size_t)b * n + start;
  for (int j = threadIdx.x; j < w; j += blockDim.x) so[j] = psrc[j];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const bool holds_slot = lane < nsample;
  for (int qi = threadIdx.x >> 5; qi < tm; qi += blockDim.x >> 5) {
    const size_t q = (size_t)b * m + (size_t)tile * tm + qi;
    const float qx = qs[q * 3 + 0];
    const float qy = qs[q * 3 + 1];
    const float qz = qs[q * 3 + 2];
    int key = INT_MAX;  // this lane's slot of the sorted picks
    int col = 0;
    int count = 0;  // in-ball columns so far, the same in every lane
    for (int base = 0; base < w; base += 32) {
      const int j = base + lane;
      bool in = false;
      int orig = 0;
      if (j < w) {
        in = dist2(qx, qy, qz, sx[j], sy[j], sz[j]) < r2;
        orig = so[j];
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
    const int c = count < nsample ? count : nsample;
    const int first_key = __shfl_sync(kFull, key, 0);
    const int first_col = __shfl_sync(kFull, col, 0);
    if (holds_slot) {
      const bool used = lane < c;
      idx[q * nsample + lane] = used ? key : (c > 0 ? first_key : 0);
      if (kWithPos) pos[q * nsample + lane] = used ? col : (c > 0 ? first_col : 0);
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
  const size_t smem = (size_t)w * 16;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ball_query_tiles_kernel<kWithPos>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(m / tm, b);
  ball_query_tiles_kernel<kWithPos><<<grid, kBqThreads, smem, stream>>>(
      xs, perm, qs, lo, n, m, tm, w, r2, nsample, idx, pos, cnt);
  return cudaGetLastError();
}

}  // namespace pn2_window
