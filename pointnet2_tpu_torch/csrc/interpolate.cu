// three_interpolate forward: out[q, c] = w0*p[i0, c] + w1*p[i1, c] + w2*p[i2, c],
// optionally followed in the same output row by the row's skip features.
//
// Replaces: pointnet2_tpu/ops/pallas/interpolate.py:48 `_ti_kernel`
//           (reached through `_ti_fwd`, interpolate.py:68-109, and
//           `three_interpolate_pallas`, interpolate.py:187-192), and the
//           feature-propagation concat after it (pointnet2_tpu/nn/pointnet.py
//           FeaturePropagation: `concatenate([interpolated, points1], -1)`).
//
// Semantics: the inverse-distance blend of three gathered feature rows per
// query, accumulated in float32 in the order j = 0, 1, 2 with a rounding
// after every product and sum (no FMA), as the plain PyTorch version does.
// With a skip source (b, n, c1), read through its batch and row strides, the
// output is (b, n, c + c1): the blend in channels [0, c), the skip row copied
// into [c, c + c1), which is torch.cat([blend, skip], -1) bit for bit.
//
// What bounds it on the H100: bytes. Each output element costs 5 flops and 4
// bytes written, far below the card's 20 flops a byte; the (B, N, C) output
// is most of the traffic, and the (B, M, C) feature rows, read three times a
// query, stay in the 50 MB L2. Writing the skip into the same rows saves the
// concat its own read and write of the blend (at FP4, B=8: 33.5 MB each).
//
// Design: one warp takes one output row. Lanes 0-2 read the row's three
// indices and weights once and the warp shares them by shuffle; there is one
// integer division a row (its cloud), none an element. The lanes walk the
// channels with 16-byte loads and stores where the source rows and the output
// rows are 16-byte aligned (C and C + C1 multiples of 4), else with 4-byte
// ones, consecutive lanes on consecutive floats: FP4's output row of 128 + 3
// floats takes the 4-byte path, which on the H100 ran faster there (51
// against 70 us at B=16, PERF.md) than 16-byte loads with each lane storing
// its 4 floats apart. The skip row is copied after the blend, 16 bytes at a
// time where it and its place in the output are aligned. The TPU kernel
// instead builds a dense (tile, M) weight block and multiplies it on the MXU,
// because Mosaic has no vector gather; on this card that would do M/3 times
// the work for nothing.
//
// ---------------------------------------------------------------------------
// three_interpolate backward (second entry, pn2_three_interpolate_grad):
//   dpoints[m, c] = sum over the pairs (q, j) with idx[q, j] == m of
//                   weight[q, j] * g[q, c]          (ThreeInterpolateGrad).
//
// Replaces: pointnet2_tpu/ops/pallas/interpolate.py:112 `_ti_bwd_kernel`
//           (launched by `_ti_bwd`, interpolate.py:137-184, from the
//           custom_vjp at interpolate.py:187-218).
//
// What bounds it on the H100: bytes. The (B, N, C) cotangent is read once
// (67 MB at FP4, batch 16), the (B, M, C) result is an eighth to a quarter of
// that and stays in L2 while it is summed; 2 flops a product.
//
// Design: a scatter-add with float atomics. The result is zero-filled on the
// stream (part of the call), then one thread per element of g, consecutive
// threads on consecutive channels, reads its g once (through g's own batch
// and row strides: autograd hands over a channel slice of the concat's
// cotangent, which is read in place, not copied) and issues three
// `atomicAdd(float)` into the three rows its query names. A warp's 32 atomics
// go to 32 consecutive floats of one row, which the L2 takes as one
// transaction. The TPU kernel has no vector scatter, so it builds a dense
// (tile, N) block of W^T with three compare-selects and multiplies it on the
// MXU; here that would do N/3 times the work. The alternative, a counting
// sort of idx into per-row lists summed in a fixed order, is deterministic
// but needs three more passes; this one was chosen because it is one short
// kernel whose only cost is the order: the addends of an element (about
// 3*N/M of them, 12 to 24 on the train path) are summed in the order the
// atomics arrive, which changes from run to run, so the result is held to
// its plain version within a tolerance, not bit for bit. Products are
// rounded before they are added (`__fmul_rn`; an atomic cannot fuse).
// An index outside [0, M) adds nothing (the plain version raises on one).

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float blend(float w0, float a, float w1, float b, float w2, float c) {
  float acc = __fmul_rn(w0, a);
  acc = __fadd_rn(acc, __fmul_rn(w1, b));
  return __fadd_rn(acc, __fmul_rn(w2, c));
}

// kVec: 16-byte loads and stores, else 4-byte ones. Grid: ceil(rows /
// (threads / 32)) blocks of `threads`, a warp a row; out rows out_stride apart.
template <bool kVec>
__global__ void three_interpolate_kernel(const float* __restrict__ points,
                                         const int* __restrict__ idx,
                                         const float* __restrict__ weight, int m,
                                         int n, int c, int rows,
                                         float* __restrict__ out, int out_stride,
                                         const float* __restrict__ skip,
                                         long long skip_stride_b, long long skip_stride_n,
                                         int c1, bool skip_vec) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;  // a whole warp: the shuffles below see all 32 lanes
  int iv = 0;
  float wv = 0.f;
  if (lane < 3) {
    iv = idx[(size_t)row * 3 + lane];
    wv = weight[(size_t)row * 3 + lane];
  }
  const int i0 = __shfl_sync(0xffffffffu, iv, 0);
  const int i1 = __shfl_sync(0xffffffffu, iv, 1);
  const int i2 = __shfl_sync(0xffffffffu, iv, 2);
  const float w0 = __shfl_sync(0xffffffffu, wv, 0);
  const float w1 = __shfl_sync(0xffffffffu, wv, 1);
  const float w2 = __shfl_sync(0xffffffffu, wv, 2);
  const int bi = row / n;
  const float* pb = points + (size_t)bi * m * c;
  const float* p0 = pb + (size_t)i0 * c;
  const float* p1 = pb + (size_t)i1 * c;
  const float* p2 = pb + (size_t)i2 * c;
  float* o = out + (size_t)row * out_stride;
  if constexpr (kVec) {
    for (int ch = 4 * lane; ch < c; ch += 128) {
      const float4 a = *reinterpret_cast<const float4*>(p0 + ch);
      const float4 b = *reinterpret_cast<const float4*>(p1 + ch);
      const float4 d = *reinterpret_cast<const float4*>(p2 + ch);
      *reinterpret_cast<float4*>(o + ch) =
          make_float4(blend(w0, a.x, w1, b.x, w2, d.x), blend(w0, a.y, w1, b.y, w2, d.y),
                      blend(w0, a.z, w1, b.z, w2, d.z), blend(w0, a.w, w1, b.w, w2, d.w));
    }
  } else {
    for (int ch = lane; ch < c; ch += 32) o[ch] = blend(w0, p0[ch], w1, p1[ch], w2, p2[ch]);
  }
  if (skip != nullptr) {
    const float* s = skip + bi * skip_stride_b + (long long)(row - bi * n) * skip_stride_n;
    float* os = o + c;
    if (skip_vec) {
      for (int ch = 4 * lane; ch < c1; ch += 128) {
        *reinterpret_cast<float4*>(os + ch) = *reinterpret_cast<const float4*>(s + ch);
      }
    } else {
      for (int ch = lane; ch < c1; ch += 32) os[ch] = s[ch];
    }
  }
}

__global__ void three_interpolate_grad_kernel(const float* __restrict__ g,
                                              long long g_stride_b,
                                              long long g_stride_n,
                                              const int* __restrict__ idx,
                                              const float* __restrict__ weight,
                                              int m, int n, int c, int total,
                                              float* __restrict__ dpoints) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int ch = t % c;
  const int q = t / c;  // b * n + row
  const int bi = q / n;
  float* d = dpoints + (size_t)bi * m * c + ch;
  const int* iq = idx + (size_t)q * 3;
  const float* wq = weight + (size_t)q * 3;
  const float gv = g[bi * g_stride_b + (q - bi * n) * g_stride_n + ch];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int row = iq[j];
    if ((unsigned)row < (unsigned)m) atomicAdd(d + (size_t)row * c, __fmul_rn(wq[j], gv));
  }
}

}  // namespace

extern "C" {

// points (b, m, c), idx (b, n, 3) i32, weight (b, n, 3) f32 -> out (b, n, c + c1)
// f32, rows out_stride = c + c1 floats apart: the blend in [0, c) and, when
// skip is not null, the skip rows (b, n, c1) f32, their channels adjacent,
// batch and row strides in elements, in [c, c + c1). vec: 16-byte loads
// and stores (points and out 16-byte aligned, c and out_stride multiples of
// 4), else 4-byte ones; skip_vec: the skip is copied 16 bytes at a time (vec,
// skip aligned, its strides and c1 multiples of 4). A warp a row, blocks of
// `threads`.
// Returns cudaGetLastError() after the launch.
int pn2_three_interpolate(const float* points, const int* idx, const float* weight,
                          int b, int m, int n, int c, float* out, int out_stride,
                          const float* skip, long long skip_stride_b, long long skip_stride_n,
                          int c1, int vec, int skip_vec, int threads, int device,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (threads < 32 || threads > 1024 || threads % 32 || (skip_vec && !vec)) {
    return (int)cudaErrorInvalidValue;
  }
  const int rows = b * n;
  const int per_block = threads >> 5;
  const int blocks = (rows + per_block - 1) / per_block;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    three_interpolate_kernel<true><<<blocks, threads, 0, s>>>(
        points, idx, weight, m, n, c, rows, out, out_stride, skip, skip_stride_b, skip_stride_n,
        c1, skip_vec != 0);
  } else {
    three_interpolate_kernel<false><<<blocks, threads, 0, s>>>(
        points, idx, weight, m, n, c, rows, out, out_stride, skip, skip_stride_b, skip_stride_n,
        c1, false);
  }
  return (int)cudaGetLastError();
}

// g (b, n, c) f32, idx (b, n, 3) i32, weight (b, n, 3) f32 -> dpoints (b, m, c) f32,
// which is zero-filled here, on the same stream, before the atomics.
// g's channels lie next to each other; its batch and row strides, in
// elements, are g_stride_b and g_stride_n (n * c and c when it is contiguous),
// so a cotangent that is a channel slice of a wider tensor is read where it
// lies. b * n * c must fit in an int. Returns the first CUDA error, or 0.
int pn2_three_interpolate_grad(const float* g, long long g_stride_b, long long g_stride_n,
                               const int* idx, const float* weight,
                               int b, int m, int n, int c, float* dpoints, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(dpoints, 0, (size_t)b * m * c * sizeof(float), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const int total = b * n * c;
  const int blocks = (int)(((long long)total + threads - 1) / threads);
  three_interpolate_grad_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      g, g_stride_b, g_stride_n, idx, weight, m, n, c, total, dpoints);
  return (int)cudaGetLastError();
}

const char* pn2_three_interpolate_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

const char* pn2_three_interpolate_grad_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
