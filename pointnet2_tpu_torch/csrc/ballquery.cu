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

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float dist2(float x, float y, float z,
                                       float x1, float y1, float z1) {
  const float dx = __fsub_rn(x, x1);
  const float dy = __fsub_rn(y, y1);
  const float dz = __fsub_rn(z, z1);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__global__ void ball_query_kernel(const float* __restrict__ xyz1,
                                  const float* __restrict__ xyz2, int b, int n,
                                  int m, float r2, int nsample,
                                  int* __restrict__ idx, int* __restrict__ cnt) {
  const int warps_per_block = blockDim.x >> 5;
  const long long q = (long long)blockIdx.x * warps_per_block + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= (long long)b * m) return;  // the whole warp leaves together

  const float* data = xyz1 + (size_t)(q / m) * n * 3;
  const float qx = xyz2[q * 3 + 0];
  const float qy = xyz2[q * 3 + 1];
  const float qz = xyz2[q * 3 + 2];
  int* out = idx + q * nsample;

  int count = 0;  // hits so far, the same in every lane
  int first = 0;
  for (int base = 0; base < n && count < nsample; base += 32) {
    const int j = base + lane;
    bool in = false;
    if (j < n) {
      in = dist2(qx, qy, qz, data[j * 3 + 0], data[j * 3 + 1], data[j * 3 + 2]) < r2;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, in);
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

const char* pn2_ball_query_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
