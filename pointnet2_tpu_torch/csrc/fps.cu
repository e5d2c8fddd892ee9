// Farthest point sampling, with the chosen rows (fps_centroids) or without
// them (farthest_point_sample): one kernel, the rows a template parameter.
//
// Replaces: pointnet2_tpu/ops/pallas/fps.py:89 `_fps_fused_kernel`
//           (reached through `fps_centroids_pallas`, fps.py:168-215), entry
//           `pn2_fps_centroids`;
//           pointnet2_tpu/ops/pallas/fps.py:40 `_fps_kernel` (reached through
//           `farthest_point_sample_pallas`, fps.py:252-283), entry
//           `pn2_farthest_point_sample`. Both give the same indices bit for bit.
//
// Semantics: slot 0 is index 0. Each of the npoint-1 steps folds the squared
// distance to the last chosen point, (x-x1)^2+(y-y1)^2+(z-z1)^2 in float32 and
// in that order, into a running minimum that starts at 1e38, and picks the
// first index of its maximum. The chosen rows are copied out bit for bit.
//
// What bounds it on the H100: neither bytes nor operations. The steps form a
// serial chain of npoint-1 dependent block-wide argmax reductions, and a
// batch of B clouds fills only B of the 132 SMs. The bound from the work
// (about 10 operations per point and step) is microseconds; the chain of
// barriers is milliseconds.
//
// Design: one thread block per cloud. The running minimum lives in shared
// memory (4 bytes a point, 32 KB at N = 8192) and never goes to device
// memory; the coordinates are read through L1, where they stay after the
// first step. Each step is a strided scan (strict `>` keeps a thread's first
// index on ties), a warp-shuffle argmax on (value, -index), and one more
// shuffle reduction over the warps' winners. A cluster or multi-block design
// that shortens the chain is later work.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float dist2(float x, float y, float z,
                                       float x1, float y1, float z1) {
  // Explicit round-to-nearest ops: no FMA contraction, so the sum is the
  // oracle's ((dx*dx + dy*dy) + dz*dz) bit for bit.
  const float dx = __fsub_rn(x, x1);
  const float dy = __fsub_rn(y, y1);
  const float dz = __fsub_rn(z, z1);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Larger value wins; on equal values the smaller index wins.
__device__ __forceinline__ void argmax_merge(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v2 = __shfl_down_sync(0xffffffffu, v, off);
    const int i2 = __shfl_down_sync(0xffffffffu, i, off);
    argmax_merge(v, i, v2, i2);
  }
}

// kRows: also copy each chosen row to out_xyz (unused, may be null, without).
template <bool kRows>
__global__ void fps_kernel(const float* __restrict__ xyz, int n, int npoint,
                           int* __restrict__ idx, float* __restrict__ out_xyz) {
  extern __shared__ float min_d[];  // n floats
  __shared__ float warp_val[32];
  __shared__ int warp_idx[32];
  __shared__ int chosen;

  const float* pts = xyz + (size_t)blockIdx.x * n * 3;
  int* idx_b = idx + (size_t)blockIdx.x * npoint;
  float* out_b = kRows ? out_xyz + (size_t)blockIdx.x * npoint * 3 : nullptr;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int i = tid; i < n; i += blockDim.x) min_d[i] = 1e38f;
  if (tid == 0) {
    idx_b[0] = 0;
    if (kRows) {
      out_b[0] = pts[0];
      out_b[1] = pts[1];
      out_b[2] = pts[2];
    }
  }

  int old = 0;
  for (int j = 1; j < npoint; ++j) {
    const float x1 = pts[old * 3 + 0];
    const float y1 = pts[old * 3 + 1];
    const float z1 = pts[old * 3 + 2];
    // Every min_d >= 0, so -1 loses to any point a thread owns.
    float best = -1.0f;
    int best_i = n;
    // A walking pointer: left to itself, the compiler may rebuild the 64-bit
    // address of point i from the block's offset in every iteration.
    const float* p = pts + 3 * tid;
    for (int i = tid; i < n; i += blockDim.x, p += 3 * blockDim.x) {
      const float d = dist2(p[0], p[1], p[2], x1, y1, z1);
      const float m = fminf(min_d[i], d);
      min_d[i] = m;
      if (m > best) {
        best = m;
        best_i = i;
      }
    }
    warp_argmax(best, best_i);
    if (lane == 0) {
      warp_val[warp] = best;
      warp_idx[warp] = best_i;
    }
    __syncthreads();
    if (warp == 0) {
      best = lane < nwarps ? warp_val[lane] : -1.0f;
      best_i = lane < nwarps ? warp_idx[lane] : n;
      warp_argmax(best, best_i);
      if (lane == 0) {
        chosen = best_i;
        idx_b[j] = best_i;
        if (kRows) {
          out_b[j * 3 + 0] = pts[best_i * 3 + 0];
          out_b[j * 3 + 1] = pts[best_i * 3 + 1];
          out_b[j * 3 + 2] = pts[best_i * 3 + 2];
        }
      }
    }
    __syncthreads();
    old = chosen;
  }
}

template <bool kRows>
cudaError_t launch_fps(const float* xyz, int b, int n, int npoint, int* idx,
                       float* out_xyz, int threads, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t smem = (size_t)n * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fps_kernel<kRows>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  fps_kernel<kRows><<<b, threads, smem, stream>>>(xyz, n, npoint, idx, out_xyz);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// xyz (b, n, 3) f32 -> idx (b, npoint) i32, out_xyz (b, npoint, 3) f32.
// Returns cudaGetLastError() after the launch.
int pn2_fps_centroids(const float* xyz, int b, int n, int npoint, int* idx,
                      float* out_xyz, int threads, int device, void* stream) {
  return (int)launch_fps<true>(xyz, b, n, npoint, idx, out_xyz, threads, device,
                               (cudaStream_t)stream);
}

// xyz (b, n, 3) f32 -> idx (b, npoint) i32. Returns cudaGetLastError().
int pn2_farthest_point_sample(const float* xyz, int b, int n, int npoint, int* idx,
                              int threads, int device, void* stream) {
  return (int)launch_fps<false>(xyz, b, n, npoint, idx, nullptr, threads, device,
                                (cudaStream_t)stream);
}

const char* pn2_fps_centroids_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

const char* pn2_farthest_point_sample_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
