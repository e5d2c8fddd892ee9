// Exact k nearest neighbours (k <= 16), ascending, ties to the lowest index.
//
// Replaces: pointnet2_tpu/ops/pallas/knn.py:39 `_knn_kernel`
//           (reached through `knn_pallas`, knn.py:71-125, and
//           `three_nn_pallas`, knn.py:128).
//
// Semantics: for every query, the k smallest float32 difference-form squared
// distances (dx*dx + dy*dy + dz*dz, in that order) to the reference points,
// in ascending order; equal distances keep the lower reference index first,
// as a stable sort of the distance row does.
//
// What bounds it on the H100: operations, about 9 a (query, reference) pair:
// every pair is needed. The TPU kernel makes k full-width argmin passes over a
// (tile, M) distance block; here each pair is looked at once.
//
// Design: one thread per query, 256 queries of one cloud a block. The
// references go through shared memory in 1024-point tiles, read by all the
// threads of a warp at the same address (a broadcast). Each thread keeps its
// sorted top-k in registers (k is a template parameter, so the arrays do not
// spill to local memory) and inserts with strict `<`, so a later index never
// passes an equal distance. Threads past the last query still help load the
// tiles and take part in the barriers.
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
// the scan. The TPU kernel makes k full-width passes over a (128, w) block.
//
// Design: one block of 128 threads per (cloud, tile), one thread per query;
// the window sits in dynamic shared memory (x, y, z, original index; 16
// bytes a column) and every thread reads the same column at once (a
// broadcast). The sorted top-k lives in registers and compares (distance,
// original index) lexicographically: the window is in x order, not index
// order, so the strict `<` of the kernel above would not break ties right.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 1024;
constexpr int kThreads = 256;

__device__ __forceinline__ float dist2(float x, float y, float z,
                                       float x1, float y1, float z1) {
  const float dx = __fsub_rn(x, x1);
  const float dy = __fsub_rn(y, y1);
  const float dz = __fsub_rn(z, z1);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

template <int K>
__global__ void knn_kernel(const float* __restrict__ refs,
                           const float* __restrict__ queries, int m, int nq,
                           float* __restrict__ dist, int* __restrict__ idx) {
  __shared__ float sx[kTile];
  __shared__ float sy[kTile];
  __shared__ float sz[kTile];

  const int bi = blockIdx.y;
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = qi < nq;
  const float* r = refs + (size_t)bi * m * 3;
  const size_t qrow = (size_t)bi * nq + qi;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = queries[qrow * 3 + 0];
    qy = queries[qrow * 3 + 1];
    qz = queries[qrow * 3 + 2];
  }
  float bd[K];
  int bidx[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = INFINITY;
    bidx[s] = 0;
  }

  for (int t0 = 0; t0 < m; t0 += kTile) {
    const int tn = min(kTile, m - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < tn; i += blockDim.x) {
      sx[i] = r[(size_t)(t0 + i) * 3 + 0];
      sy[i] = r[(size_t)(t0 + i) * 3 + 1];
      sz[i] = r[(size_t)(t0 + i) * 3 + 2];
    }
    __syncthreads();
    if (!active) continue;
    for (int i = 0; i < tn; ++i) {
      const float d = dist2(qx, qy, qz, sx[i], sy[i], sz[i]);
      if (d < bd[K - 1]) {
        const int j = t0 + i;
        // Walk down from the last slot: slot s takes slot s-1's entry when d
        // sorts before it, else d itself if d sorts before slot s.
#pragma unroll
        for (int s = K - 1; s >= 0; --s) {
          if (s > 0 && d < bd[s - 1]) {
            bd[s] = bd[s - 1];
            bidx[s] = bidx[s - 1];
          } else if (d < bd[s]) {
            bd[s] = d;
            bidx[s] = j;
          }
        }
      }
    }
  }
  if (active) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      dist[qrow * K + s] = bd[s];
      idx[qrow * K + s] = bidx[s];
    }
  }
}

template <int K>
cudaError_t launch(const float* refs, const float* queries, int b, int m, int nq,
                   float* dist, int* idx, cudaStream_t stream) {
  const dim3 grid((nq + kThreads - 1) / kThreads, b);
  knn_kernel<K><<<grid, kThreads, 0, stream>>>(refs, queries, m, nq, dist, idx);
  return cudaGetLastError();
}

constexpr int kTileQueries = 128;

__device__ __forceinline__ bool before(float d, int o, float bd, int bo) {
  return d < bd || (d == bd && o < bo);
}

// Grid (tiles, b), kTileQueries threads, 16 * w bytes of dynamic shared memory.
// xs (b, m, 3), perm (b, m) sorted; qs (b, nq, 3) sorted, nq = 128 * tiles;
// lo (b, tiles); dist/idx (b, nq, K) in sorted query order.
template <int K>
__global__ void knn_tiles_kernel(const float* __restrict__ xs,
                                 const int* __restrict__ perm,
                                 const float* __restrict__ qs,
                                 const int* __restrict__ lo, int m, int nq,
                                 int w, float* __restrict__ dist,
                                 int* __restrict__ idx) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + w;
  float* sz = sy + w;
  int* so = reinterpret_cast<int*>(sz + w);

  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int start = lo[b * gridDim.x + tile];
  for (int i = threadIdx.x; i < w; i += blockDim.x) {
    const int j = start + i;
    if (j < m) {
      const size_t row = (size_t)b * m + j;
      sx[i] = xs[row * 3 + 0];
      sy[i] = xs[row * 3 + 1];
      sz[i] = xs[row * 3 + 2];
      so[i] = perm[row];
    } else {
      so[i] = m;  // padding
    }
  }
  __syncthreads();

  const size_t q = (size_t)b * nq + (size_t)tile * kTileQueries + threadIdx.x;
  const float qx = qs[q * 3 + 0];
  const float qy = qs[q * 3 + 1];
  const float qz = qs[q * 3 + 2];
  float bd[K];
  int bo[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = INFINITY;
    bo[s] = INT_MAX;
  }
  int lowest = m;  // the lowest original index in the window
  for (int i = 0; i < w; ++i) {
    const int o = so[i];
    if (o >= m) continue;
    lowest = min(lowest, o);
    const float d = dist2(qx, qy, qz, sx[i], sy[i], sz[i]);
    if (before(d, o, bd[K - 1], bo[K - 1])) {
#pragma unroll
      for (int s = K - 1; s >= 0; --s) {
        if (s > 0 && before(d, o, bd[s - 1], bo[s - 1])) {
          bd[s] = bd[s - 1];
          bo[s] = bo[s - 1];
        } else if (before(d, o, bd[s], bo[s])) {
          bd[s] = d;
          bo[s] = o;
        }
      }
    }
  }
#pragma unroll
  for (int s = 0; s < K; ++s) {
    dist[q * K + s] = bd[s];
    idx[q * K + s] = bd[s] == INFINITY ? lowest : bo[s];
  }
}

template <int K>
cudaError_t launch_tiles(const float* xs, const int* perm, const float* qs,
                         const int* lo, int b, int m, int nq, int w,
                         float* dist, int* idx, cudaStream_t stream) {
  const size_t smem = (size_t)w * 16;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn_tiles_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(nq / kTileQueries, b);
  knn_tiles_kernel<K><<<grid, kTileQueries, smem, stream>>>(xs, perm, qs, lo, m, nq, w, dist, idx);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// refs (b, m, 3), queries (b, nq, 3) f32 -> dist (b, nq, k) f32, idx (b, nq, k) i32.
// 1 <= k <= 16. Returns cudaGetLastError() after the launch.
int pn2_knn(const float* refs, const float* queries, int b, int m, int nq, int k,
            float* dist, int* idx, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
#define PN2_KNN_CASE(K) \
  case K:               \
    return (int)launch<K>(refs, queries, b, m, nq, dist, idx, s);
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
// tile's window start, w the window (w * 16 bytes of shared memory),
// 1 <= k <= 16 -> dist (b, nq, k) f32, idx (b, nq, k) i32, sorted query order.
int pn2_knn_tiles(const float* xs, const int* perm, const float* qs, const int* lo,
                  int b, int m, int nq, int w, int k, float* dist, int* idx,
                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
#define PN2_KNN_TILES_CASE(K) \
  case K:                     \
    return (int)launch_tiles<K>(xs, perm, qs, lo, b, m, nq, w, dist, idx, s);
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
