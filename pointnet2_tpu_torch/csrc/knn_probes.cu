// The two kNN design probes: exact k nearest neighbours by k whole-row
// selection passes over a query's distance row.
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
// Pass p takes the row's least value and the lowest column holding it, then
// sets that column to +inf. 1 <= k <= min(m, 32).
//
// What bounds it on the H100: operations, about 9 a (query, reference) pair
// for the distances (row 3's bound, csrc/knn.cu); the k passes re-read the
// row from shared memory on top of that, k (v3) or up to 2k (v1) reads a
// pair, so these formulations sit far above the bound by design. The TPU
// kernels run the passes over (tile, M) blocks in VMEM; here a warp holds a
// query's row in shared memory.
//
// Design: one block per (cloud, run of queries). The block stages the
// cloud's references into shared memory once with 4-byte `cp.async`, as
// three arrays (x, y, z), then each of its W warps takes one query at a time:
// its lanes compute the row's distances into the warp's row of M floats in
// shared memory (column j in lane j mod 32, so a lane's reads never share a
// bank with another lane's), and make the k passes over it.
// - `pn2_knn_argmin` (v1): a pass is two full-width sweeps and two warp
//   reductions: the row's least value (`redux.sync` min of the bit patterns,
//   which order as the non-negative floats and +inf do), then the lowest
//   column that holds it (each lane's first, then `redux.sync` min).
// - `pn2_knn_tracked` (v3): a pass is one sweep in which each lane keeps a
//   (value, column) candidate over its columns in index order with a strict
//   `<`, so its earliest column wins a tie; then one warp reduction on the
//   64-bit (value bits, column) pair by butterfly shuffles gives the least
//   value and, among equals, the lowest column.
// Lane p keeps pass p's pick; lanes 0..k-1 write them at the end.
//
// Limits: k <= 32 (a pick a lane). The references and at least one warp's
// row fit a block's 227 KB of dynamic shared memory: (3 + W) x M x 4 bytes,
// so M <= 232448 / 16 = 14528 (W = 1). FP4's 3-NN (M = 1024, W = 8) and SA
// kNN grouping (M = 8192, W = 4) both fit. The wrapper (ops/cuda/probes.py)
// raises past them.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>

#include "window_bq.cuh"

namespace {

using pn2_window::dist2;
using pn2_window::kFull;

constexpr int kMaxK = 32;
constexpr int kMaxWarps = 8;
constexpr int kMaxShared = 232448;  // H100: 227 KB of dynamic shared memory a block

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// Grid: (ceil(nq / per_block), b) blocks of W warps; dynamic shared memory
// (3 + W) * m * 4 bytes.
template <bool kTracked>
__device__ __forceinline__ void knn_rows(const float* __restrict__ refs,
                                         const float* __restrict__ queries, int m, int nq, int k,
                                         int per_block, float* __restrict__ dist,
                                         int* __restrict__ idx) {
  extern __shared__ __align__(16) float sm[];
  float* rx = sm;
  float* ry = sm + m;
  float* rz = sm + 2 * m;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  unsigned* row = reinterpret_cast<unsigned*>(sm + (size_t)(3 + warp) * m);
  const int cloud = blockIdx.y;
  const float* src = refs + (size_t)cloud * m * 3;
  for (int f = threadIdx.x; f < 3 * m; f += blockDim.x) {
    const int j = f / 3;
    cp_async4(sm + (f - 3 * j) * m + j, src + f);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const int q_end = min(nq, (int)(blockIdx.x + 1) * per_block);
  for (int q = (int)blockIdx.x * per_block + warp; q < q_end; q += warps) {
    const size_t at = (size_t)cloud * nq + q;
    const float qx = queries[at * 3 + 0];
    const float qy = queries[at * 3 + 1];
    const float qz = queries[at * 3 + 2];
    for (int j = lane; j < m; j += 32) row[j] = __float_as_uint(dist2(qx, qy, qz, rx[j], ry[j], rz[j]));
    __syncwarp();
    unsigned my_key = 0u, my_col = 0u;
    for (int p = 0; p < k; ++p) {
      unsigned key, col;
      if (kTracked) {
        unsigned bv = UINT_MAX, bi = UINT_MAX;
        for (int j = lane; j < m; j += 32) {
          const unsigned v = row[j];
          if (v < bv) {
            bv = v;
            bi = (unsigned)j;
          }
        }
        unsigned long long pair = ((unsigned long long)bv << 32) | bi;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const unsigned long long other = __shfl_xor_sync(kFull, pair, off);
          pair = other < pair ? other : pair;
        }
        key = (unsigned)(pair >> 32);
        col = (unsigned)pair;
      } else {
        unsigned least = UINT_MAX;
        for (int j = lane; j < m; j += 32) least = min(least, row[j]);
        key = __reduce_min_sync(kFull, least);
        unsigned first = UINT_MAX;
        for (int j = lane; j < m; j += 32) {
          if (row[j] == key) {
            first = (unsigned)j;
            break;
          }
        }
        col = __reduce_min_sync(kFull, first);
      }
      if (lane == p) {
        my_key = key;
        my_col = col;
      }
      if (lane == (int)(col & 31u)) row[col] = __float_as_uint(INFINITY);
      __syncwarp();
    }
    if (lane < k) {
      dist[at * k + lane] = __uint_as_float(my_key);
      idx[at * k + lane] = (int)my_col;
    }
    __syncwarp();  // the next query's row overwrites this one
  }
}

__global__ void __launch_bounds__(kMaxWarps * 32)
    knn_argmin_kernel(const float* __restrict__ refs, const float* __restrict__ queries, int m,
                      int nq, int k, int per_block, float* __restrict__ dist,
                      int* __restrict__ idx) {
  knn_rows<false>(refs, queries, m, nq, k, per_block, dist, idx);
}

__global__ void __launch_bounds__(kMaxWarps * 32)
    knn_tracked_kernel(const float* __restrict__ refs, const float* __restrict__ queries, int m,
                       int nq, int k, int per_block, float* __restrict__ dist,
                       int* __restrict__ idx) {
  knn_rows<true>(refs, queries, m, nq, k, per_block, dist, idx);
}

template <auto kKernel>
cudaError_t launch(const float* refs, const float* queries, int b, int m, int nq, int k,
                   int warps, int per_block, float* dist, int* idx, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t smem = (size_t)(3 + warps) * m * 4;
  if (k < 1 || k > kMaxK || k > m || b < 1 || b > 65535 || nq < 1 || warps < 1 ||
      warps > kMaxWarps || per_block < 1 || smem > (size_t)kMaxShared)
    return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((nq + per_block - 1) / per_block), (unsigned)b);
  kKernel<<<grid, warps * 32, smem, (cudaStream_t)stream>>>(refs, queries, m, nq, k, per_block,
                                                             dist, idx);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// refs (b, m, 3), queries (b, nq, 3) f32 -> dist (b, nq, k) f32, idx (b, nq,
// k) i32, v1's passes (min, then the lowest column holding it). Blocks of
// `warps` warps take `per_block` queries each ((3 + warps) * m * 4 bytes of
// shared memory <= 232448; 1 <= k <= min(m, 32); b <= 65535). Returns
// cudaGetLastError() after the launch.
int pn2_knn_argmin(const float* refs, const float* queries, int b, int m, int nq, int k,
                   int warps, int per_block, float* dist, int* idx, int device, void* stream) {
  return (int)launch<knn_argmin_kernel>(refs, queries, b, m, nq, k, warps, per_block, dist, idx,
                                        device, stream);
}

// The same function with v3's passes (one (value, column) reduction). Same
// arguments and limits.
int pn2_knn_tracked(const float* refs, const float* queries, int b, int m, int nq, int k,
                    int warps, int per_block, float* dist, int* idx, int device, void* stream) {
  return (int)launch<knn_tracked_kernel>(refs, queries, b, m, nq, k, warps, per_block, dist, idx,
                                         device, stream);
}

const char* pn2_knn_argmin_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

const char* pn2_knn_tracked_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
