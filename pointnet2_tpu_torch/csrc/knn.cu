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

const char* pn2_knn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
